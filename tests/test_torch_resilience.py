"""The port's in-run retries and chaos seams (``bolt_tpu_torch/_chaos.py``,
``bolt_tpu_torch/stream.py``) against the reference's
(``tests/test_resilience.py``).

The registry's determinism, the retry budget (absorbed faults, chained
exhaustion, the re-sequencer's fence against duplicate deliveries) and
the deduplicated dead-thread report, each as the reference holds its
own; the streamed results go through ``bolt_tpu`` (the 8-device CPU
mesh) and the port with ``context=torch.device("cpu")``.  Sources are
integer-valued f64, so a sum is exact under any fold order and a retried
run is compared bit for bit: with the run with no fault, with numpy and
with the reference.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import _chaos as chaos
from bolt_tpu_torch import _lockdep, engine, stream
from bolt_tpu_torch.utils import chain_retry_step, code_token

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N = 32
SHAPE = (N, 6, 4)


@pytest.fixture(autouse=True)
def _no_armed_chaos():
    """Every test leaves the fault registry empty."""
    chaos.clear()
    yield
    chaos.clear()


def _intdata():
    return ((np.arange(np.prod(SHAPE)) % 13) - 6).astype(
        np.float64).reshape(SHAPE)


def _source(data, chunks=4, codec=None):
    return bolt.fromcallback(lambda idx: data[idx], data.shape, CPU,
                             dtype=data.dtype, chunks=chunks, codec=codec)


def _a(b):
    return np.asarray(b.toarray())


# ---------------------------------------------------------------------
# the chaos registry
# ---------------------------------------------------------------------

def test_chaos_nth_hit_and_times():
    chaos.inject("t.seam", nth=3)
    chaos.hit("t.seam")
    chaos.hit("t.seam")
    with pytest.raises(chaos.ChaosError, match="t.seam"):
        chaos.hit("t.seam")
    chaos.hit("t.seam")                  # times=1: disarmed after 1 trip
    assert chaos.stats("t.seam") == (4, 1)
    chaos.clear("t.seam")
    assert chaos.active() == []


def test_chaos_custom_exc_and_unbounded_times():
    chaos.inject("t.seam2", nth=1, exc=IOError("link down"), times=None)
    for _ in range(3):
        with pytest.raises(IOError, match="link down"):
            chaos.hit("t.seam2")
    assert chaos.stats("t.seam2") == (3, 3)


def test_chaos_env_form(monkeypatch):
    monkeypatch.setenv("BOLT_CHAOS", "x.y:2:raise:disk gone")
    chaos._load_env()
    chaos.hit("x.y")
    with pytest.raises(chaos.ChaosError, match="disk gone"):
        chaos.hit("x.y")
    with pytest.raises(ValueError, match="point:nth"):
        monkeypatch.setenv("BOLT_CHAOS", "malformed")
        chaos._load_env()


def test_chaos_rejects_unknown_action():
    with pytest.raises(ValueError, match="raise.*kill"):
        chaos.inject("t.x", action="explode")


def test_chaos_disarmed_is_free():
    assert not chaos._ARMED
    chaos.hit("never.armed")             # no-op, no counting
    assert chaos.stats("never.armed") == (0, 0)


def test_chaos_kill_action_ends_the_process():
    # the preemption form: SIGKILL, nothing runs after it
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bolt_tpu_torch import _chaos\n"
            "_chaos.hit('p.q')\n"
            "print('survived')\n" % ROOT)
    env = dict(os.environ, BOLT_CHAOS="p.q:1:kill")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -9 and "survived" not in out.stdout


def test_chaos_loads_alone_and_ranks_its_lock():
    # stdlib only: the registry loads by path with no torch and no package,
    # and its lock keeps the reference's rank
    code = ("import sys, importlib.util\n"
            "sys.modules['torch'] = None\n"
            "spec = importlib.util.spec_from_file_location('c', %r)\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "m.inject('a.b'); m.clear()\n"
            % os.path.join(ROOT, "bolt_tpu_torch", "_chaos.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    from bolt_tpu import _lockdep as ref_lockdep
    assert _lockdep.RANKS["chaos.registry"] == \
        ref_lockdep.RANKS["chaos.registry"] == 68
    assert set(chaos.SEAMS) <= set(__import__(
        "bolt_tpu._chaos", fromlist=["SEAMS"]).SEAMS)


def test_chaos_under_the_armed_witness():
    # the registry's lock (created with the module) is a named lock of
    # the inventory; a retried run under the armed witness records no
    # violation
    was = _lockdep.enabled()
    _lockdep.reset()
    _lockdep.enable()
    try:
        chaos.inject("stream.upload", nth=2)
        with stream.retries(1), stream.uploaders(2):
            assert np.array_equal(_a(_source(_intdata()).sum()),
                                  _intdata().sum(axis=0))
        assert _lockdep.violations() == []
        assert chaos._LOCK.name == "chaos.registry"
    finally:
        _lockdep.disable()
        _lockdep.reset()
        if was:
            _lockdep.enable()


# ---------------------------------------------------------------------
# in-run retry: absorbed faults, chained exhaustion, fencing
# ---------------------------------------------------------------------

def test_retry_scope_and_env(monkeypatch):
    before = stream.retry_limit()
    assert before == 0                   # default: fail-fast
    with stream.retries(3):
        assert stream.retry_limit() == 3
    assert stream.retry_limit() == before
    stream.set_retries(2)
    try:
        assert stream.retry_limit() == 2
    finally:
        stream.set_retries(before)


def test_retry_scope_is_thread_local():
    seen = {}

    def other():
        seen["other"] = stream.retry_limit()

    with stream.retries(4):
        th = threading.Thread(target=other)
        th.start()
        th.join(10)
        assert not th.is_alive()
        seen["main"] = stream.retry_limit()
    assert seen == {"other": 0, "main": 4}


def test_retry_absorbs_uploader_fault_bit_identical(mesh):
    data = _intdata()
    clean = _a(_source(data).sum())
    chaos.inject("stream.upload", nth=3)         # one trip, then healthy
    c0 = engine.counters()
    with stream.retries(2):
        got = _a(_source(data).sum())
    c1 = engine.counters()
    assert np.array_equal(got, clean)
    assert c1["stream_retries"] - c0["stream_retries"] == 1
    want = np.asarray(ref.fromcallback(lambda idx: data[idx], SHAPE, mesh,
                                       dtype=np.float64, chunks=4)
                      .sum().toarray())
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seam", ["stream.encode", "stream.upload",
                                  "stream.dispatch", "stream.fold"])
def test_each_seam_under_retries(seam):
    # a fault at every seam of a streamed run: absorbed in place where the
    # run retries it (ingest and dispatch), the original raised at the
    # final fold (the reference's contract: no retry there)
    data = _intdata().astype(np.float32)    # delta-f32 encodes f32
    clean = _a(_source(data, codec="delta-f32").sum())
    chaos.inject(seam, nth=1 if seam == "stream.fold" else 2)
    c0 = engine.counters()
    with stream.retries(1), stream.uploaders(3):
        if seam == "stream.fold":
            with pytest.raises(chaos.ChaosError, match="stream.fold"):
                _source(data, codec="delta-f32").var().toarray()
            return
        got = _a(_source(data, codec="delta-f32").sum())
    assert np.array_equal(got, clean)
    assert engine.counters()["stream_retries"] - c0["stream_retries"] == 1


def test_retry_absorbs_a_group_dispatch_fault():
    data = _intdata()
    s = _source(data)
    clean = [_a(x) for x in bolt.compute(s.sum(), s.min(), s.var())]
    chaos.inject("stream.dispatch", nth=4)
    s = _source(data)
    with stream.retries(1):
        got = [_a(x) for x in bolt.compute(s.sum(), s.min(), s.var())]
    for g, c in zip(got, clean):
        assert np.array_equal(g, c)


def test_retries_under_a_stressed_pool():
    # 16 uploaders on one-record slabs, a short switch interval and ten
    # upload faults spread over the threads: a lost retry count, a slab
    # folded twice or a stranded permit would show as a wrong sum, a
    # wrong slab or retry count, or a hang (bounded by the pool's joins)
    data = np.tile(_intdata(), (3, 1, 1)).astype(np.float32)
    clean = _a(_source(data, chunks=1).sum())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        chaos.inject("stream.upload", nth=5, times=10)
        c0 = engine.counters()
        with stream.uploaders(16), stream.prefetch(1), stream.retries(10):
            got = _a(_source(data, chunks=1).sum())
        c1 = engine.counters()
    finally:
        sys.setswitchinterval(old)
    assert np.array_equal(got, clean)
    assert c1["stream_chunks"] - c0["stream_chunks"] == 3 * N
    assert c1["stream_retries"] - c0["stream_retries"] == 10
    assert chaos.stats("stream.upload")[1] == 10
    assert not any(t.is_alive() for t in stream._LAST_POOL)


def test_retry_exhausted_chains_back_to_original():
    data = _intdata()
    chaos.inject("stream.upload", nth=2, times=None)   # never heals
    with stream.retries(2):
        with pytest.raises(RuntimeError, match="after 2 retries") as ei:
            _source(data).sum().cache()
    # final error -> last attempt -> ... -> the ORIGINAL failure
    e = ei.value.__cause__
    depth = 0
    while e is not None:
        assert isinstance(e, chaos.ChaosError)
        e = e.__cause__
        depth += 1
    assert depth == 3                    # 1 original + 2 retries


def test_default_zero_retries_keeps_original_exception():
    data = _intdata()
    for seam in ("stream.upload", "stream.dispatch"):
        boom = RuntimeError("storage went away")
        chaos.inject(seam, nth=2, exc=boom)
        with pytest.raises(RuntimeError) as ei:
            _source(data).sum().cache()
        assert ei.value is boom          # untouched, unchained
        chaos.clear()


def test_retry_covers_fromiter_upload(mesh):
    data = _intdata()
    clean = _a(bolt.fromiter([data], SHAPE, CPU, dtype=np.float64).sum())
    chaos.inject("stream.upload", nth=1)
    c0 = engine.counters()
    with stream.retries(1):
        got = _a(bolt.fromiter([data], SHAPE, CPU, dtype=np.float64).sum())
    c1 = engine.counters()
    assert np.array_equal(got, clean)
    assert c1["stream_retries"] - c0["stream_retries"] == 1


def test_chain_retry_step_policy():
    a, b = ValueError("first"), ValueError("second")
    assert chain_retry_step(a, None, 0, True, "slab 3", "knob") is a
    assert chain_retry_step(b, a, 1, True, "slab 3", "knob") is b
    assert b.__cause__ is a
    with pytest.raises(RuntimeError, match="slab 3 failed after 2") as ei:
        chain_retry_step(ValueError("third"), b, 2, False, "slab 3", "knob")
    assert ei.value.__cause__.__cause__ is b
    with pytest.raises(ValueError, match="only"):
        chain_retry_step(ValueError("only"), None, 0, False, "s", "k")


def test_reseq_fences_duplicate_deliveries():
    r = stream._Reseq()
    assert r.put(0, "a") and r.put(1, "b")
    assert not r.put(1, "late duplicate")        # still queued
    got = r.next([threading.current_thread()])
    assert got == (0, "a")
    assert not r.put(0, "after retirement")      # already folded
    assert r.fenced == 2
    assert r.next([threading.current_thread()]) == (1, "b")


def test_dead_workers_each_named_once(monkeypatch):
    # TWO dead workers: the pointed error names each exactly once
    monkeypatch.setattr(stream._Reseq, "fault", lambda self, exc: None)

    def dying(idx):
        raise RuntimeError("swallowed by the mute")

    src = bolt.fromcallback(dying, SHAPE, CPU, dtype=np.float64, chunks=4)
    with stream.uploaders(2):
        with pytest.raises(RuntimeError,
                           match="died without delivering") as ei:
            src.sum().cache()
    msg = str(ei.value)
    for w in ("'bolt-stream-upload-0'", "'bolt-stream-upload-1'"):
        assert msg.count(w) == 1, (w, msg)


def test_dead_error_fires_once_per_dead_set():
    r = stream._Reseq()

    class _T:
        def __init__(self, name):
            self.name = name
            self.ident = id(self)

        def is_alive(self):
            return False

    a, b = _T("w-0"), _T("w-1")
    e1 = r._dead([a, b])
    e2 = r._dead([a, b])
    assert e1 is e2                      # same set -> the SAME error
    assert str(e1).count("'w-0'") == 1 and str(e1).count("'w-1'") == 1
    c = _T("w-2")
    assert r._dead([a, b, c]) is not e1  # a new set is a new report


def test_code_token_distinguishes_lambda_bodies():
    from bolt_tpu.utils import code_token as ref_token
    a = code_token(lambda v: v + 1)
    b = code_token(lambda v: v * 2)
    c = code_token(lambda v: v + 2)      # same bytecode, different const
    assert a != b and a != c and b != c
    assert a.startswith("<lambda>#")
    assert code_token(np.maximum) == "maximum"   # no bytecode: name
    # stable across definitions of the same source shape, and the
    # reference's token
    assert code_token(lambda v: v + 1) == a == ref_token(lambda v: v + 1)
