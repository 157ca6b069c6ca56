"""The program's spans on a made-up window: the trace reader's readings
stay as they were when the program's ranges join the window, each
device operation goes to the span that launched it, the idle time to
the span open on the host, and the four readers of the engine's
counters and of the spans report as constructed (None where the run or
the program has nothing to read)."""

import pytest

from test_bench_tracing import Ev, window

MS = 1_000_000


class TEv(Ev):
    """An event with the thread that recorded it."""

    def __init__(self, name, start, end, device=False, corr=0, link=0,
                 thread=1):
        super().__init__(name, start, end, device, corr, link)
        self._t = thread

    def start_thread_id(self):
        return self._t


def _readings(s):
    return (s.window_s, s.busy_s, s.by_range, s.device_ops, s.idle_gaps,
            s.launches, s.unattributed_s)


def test_program_ranges_leave_the_summary_as_it_was():
    from benchmark import tracing
    bolt = [Ev("bolt.array.stat", 1 * MS, 9 * MS, corr=50),
            Ev("bolt.engine.dispatch", 2 * MS, 8 * MS, corr=51),
            Ev("bolt.array.multi_stat", 11 * MS, 58 * MS, corr=52),
            Ev("bolt.host.sync", 49 * MS, 57 * MS, corr=53)]
    assert _readings(tracing.Summary(window() + bolt)) \
        == _readings(tracing.Summary(window()))


def made_up():
    """Thread 1: the window 0-100 ms; swap 10-30 holding a dispatch
    11-29; a dispatch 40-50 under no layer; stats 60-90 holding a sync
    80-88.  Launches at 12, 41, 61, 81 and 95 ms, then a kernel with no
    launch; a device-side range and a synchronisation marker."""
    launches = [(12, 21), (41, 22), (61, 23), (81, 24), (95, 25)]
    return [
        TEv("bench.window", 0, 100 * MS, corr=1),
        TEv("bolt.array.swap", 10 * MS, 30 * MS, corr=2),
        TEv("bolt.engine.dispatch", 11 * MS, 29 * MS, corr=3),
        TEv("bolt.engine.dispatch", 40 * MS, 50 * MS, corr=4),
        TEv("bolt.array.stats", 60 * MS, 90 * MS, corr=5),
        TEv("bolt.host.sync", 80 * MS, 88 * MS, corr=6),
        # another thread's span covers the idle stretches: not the window's
        TEv("bolt.stream.ingest", 0, 100 * MS, corr=7, thread=2),
    ] + [TEv("cudaLaunchKernel", t * MS, t * MS + 10, corr=c)
         for t, c in launches] + [
        TEv("void k1", 12.5 * MS, 25 * MS, device=True, link=21),
        TEv("bolt.array.swap", 12.5 * MS, 25 * MS, device=True),
        TEv("void k2", 41 * MS, 45 * MS, device=True, link=22),
        TEv("void k3", 62 * MS, 70 * MS, device=True, link=23),
        TEv("Memcpy DtoH (Device -> Pageable)", 85 * MS, 87 * MS,
            device=True, link=24),
        TEv("Context Sync", 87 * MS, 88 * MS, device=True),
        TEv("void k5", 96 * MS, 97 * MS, device=True, link=25),
        TEv("void k6", 98 * MS, 99 * MS, device=True),
    ]


def test_operations_go_to_the_span_that_launched_them():
    from benchmark import spans
    s = spans.Spans(made_up())
    assert s.window_s == pytest.approx(0.1)
    assert s.device_ops == 6 and s.device_ranges == 1
    assert s.device_s == pytest.approx(0.0285)
    t = {k: (v[0], pytest.approx(v[1]), v[2]) for k, v in s.table.items()}
    assert t == {"array.swap": (1, 0.0125, 1),
                 "engine.dispatch": (2, 0.004, 1),
                 "array.stats": (1, 0.008, 1),
                 "host.sync": (1, 0.002, 1),
                 "stream.ingest": (1, 0.0, 0),
                 spans.NO_SPAN: (0, 0.001, 1),
                 spans.UNLINKED: (0, 0.001, 1)}
    # swap, stats and the sync under a layer: 22.5 of 28.5 ms
    assert s.layer_share() == pytest.approx(100 * 22.5 / 28.5)


def test_idle_goes_to_the_span_open_on_the_windows_thread():
    from benchmark import spans
    s = spans.Spans(made_up())
    # gaps [0, 12.5] [25, 41] [45, 62] [70, 85] [87, 96] [97, 98] [99, 100]
    assert {k: pytest.approx(v) for k, v in s.idle.items()} == {
        spans.NO_SPAN: 0.038, "array.swap": 0.0075,
        "engine.dispatch": 0.006, "array.stats": 0.014, "host.sync": 0.006}
    assert s.program_idle_s == pytest.approx(0.0335)
    line = s.line(2)
    assert line.startswith("spans: per pass of 2: ")
    assert "device-side bolt ranges 1" in line


class _Prof:
    """A stopped profiler's shape: ``profiler.kineto_results.events()``."""

    def __init__(self, events):
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


def _read(name, ctx, prof):
    """A reader called as the harness calls it: from a frame that holds
    the run's ``ctx`` and ``prof``."""
    from benchmark import common
    return common.piece("metrics", name).read(ctx)


def test_the_four_readers(capsys):
    from benchmark import harness, tracing
    events = made_up()
    e0 = {"dispatches": 10, "dispatch_seconds": 1.0, "host_syncs": 3,
          "host_sync_seconds": 0.5, "dispatch_sync_seconds": 0.25}
    e1 = {"dispatches": 30, "dispatch_seconds": 2.0, "host_syncs": 13,
          "host_sync_seconds": 0.9, "dispatch_sync_seconds": 0.45}
    ctx = harness.MetricContext(tracing.Summary(events), {}, e0, e1, 5)
    prof = _Prof(events)
    assert _read("host_syncs", ctx, prof) == 2.0
    # (1.0 s - 0.2 s of waits) over 20 dispatches
    assert _read("engine_enqueue_us", ctx, prof) == pytest.approx(40000.0)
    assert _read("device_launches", ctx, prof) == pytest.approx(1.2)
    assert _read("program_idle_pct", ctx, prof) == pytest.approx(33.5)
    # one spans: line a run, however many readers read the spans
    assert capsys.readouterr().err.count("spans: ") == 1
    assert _read("program_idle_pct", ctx, prof) <= 100.0 * (
        1 - ctx.trace.busy_s / ctx.trace.window_s)


def test_the_readers_on_a_run_with_nothing_to_read():
    from benchmark import harness, tracing
    # a program that counts no sync and opens no span (the parent's)
    old = {"dispatches": 10, "dispatch_seconds": 1.0}
    bare = [e for e in made_up() if not e.name().startswith("bolt.")]
    ctx = harness.MetricContext(tracing.Summary(bare), {}, old, old, 5)
    prof = _Prof(bare)
    assert _read("host_syncs", ctx, prof) is None
    assert _read("engine_enqueue_us", ctx, prof) is None
    assert _read("program_idle_pct", ctx, prof) is None
    assert _read("device_launches", ctx, prof) == pytest.approx(1.2)
    # no device trace (a CPU run): nothing read
    ctx = harness.MetricContext(None, {}, old, old, 5)
    for name in ("host_syncs", "engine_enqueue_us", "device_launches",
                 "program_idle_pct"):
        assert _read(name, ctx, prof) is None


def test_a_reader_outside_a_run_finds_no_profiler():
    from benchmark import common, harness, tracing
    old = {"dispatches": 10, "dispatch_seconds": 1.0}
    ctx = harness.MetricContext(tracing.Summary(made_up()), {}, old, old, 5)
    assert common.piece("metrics", "device_launches").read(ctx) is None
