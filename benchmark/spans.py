"""The program's own spans on the traced window.

While a profiler records, every ``obs`` span of ``bolt_tpu_torch``
opens a host-side range ``bolt.<span>`` (``obs/trace.py``), on the
profiler's clock and beside the device operations launched inside it.
:class:`Spans` reads them from the same kineto events as
``tracing.Summary``, with the same device operations (kernels, copies
and fills; no range, no synchronisation marker):

* each device operation goes to the program span that launched it: the
  innermost span open on the launching thread at its launch (the
  runtime call its ``linked_correlation_id`` names), the engine's own
  spans (``engine.*``) passed over where a layer's span holds them;
* the window's idle time (no device operation running) goes to the
  innermost program span open on the window's thread.

The harness hands a reader only ``tracing.Summary``, which keeps no
event, so :func:`of` reads the events from the stopped profiler of the
run that called the reader (see PERF.md, Open questions)."""

import sys

from benchmark import tracing

PROGRAM = "bolt."
ENGINE = "engine."
NO_SPAN = "(no span)"
UNLINKED = "(unlinked)"


def _stacks_at(ranges, times):
    """For each of the sorted ``times``, the names of the ``ranges``
    (``(start, end, name)`` sorted by start, nested as spans nest) open
    at it, outermost first."""
    out = []
    stack = []
    i = 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            s, e, name = ranges[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, name))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out.append(tuple(n for _, n in stack))
    return out


def owner(stack):
    """The span an operation or an idle stretch belongs to: the
    innermost of ``stack`` that is not the engine's own, else the
    innermost engine span, else :data:`NO_SPAN`."""
    for name in reversed(stack):
        if not name.startswith(ENGINE):
            return name
    return stack[-1] if stack else NO_SPAN


def is_layer(name):
    """Whether device time under ``name`` is under a layer's span."""
    return name not in (NO_SPAN, UNLINKED) and not name.startswith(ENGINE)


class Spans:
    """What the program's spans show of one profiled window.
    ``table``: ``{span: [calls, device seconds, device operations]}``
    (calls: the span's ranges that open in the window); ``device_ops``:
    the window's kernels, copies and fills, counted; ``device_s``: their
    summed time; ``idle``: ``{span: idle seconds}``, :data:`NO_SPAN`
    the idle stretches outside every program span; ``program_idle_s``:
    the rest; ``window_s``; ``device_ranges``: device-side ``bolt.``
    annotations seen (the program makes none; such an event would be a
    range, not an operation)."""

    def __init__(self, events):
        dev, launch, ranges = [], {}, {}
        window = None
        self.device_ranges = 0
        for e in events:
            name = e.name()
            if tracing._is_device(e):
                if name.startswith(PROGRAM):
                    self.device_ranges += 1
                elif tracing.is_operation(name):
                    dev.append((e.start_ns(), e.end_ns(),
                                e.linked_correlation_id()))
                continue
            tid = _thread(e)
            if e.correlation_id():
                launch[e.correlation_id()] = (e.start_ns(), tid)
            if name == tracing.WINDOW:
                window = (e.start_ns(), e.end_ns(), tid)
            elif name.startswith(PROGRAM):
                ranges.setdefault(tid, []).append(
                    (e.start_ns(), e.end_ns(), name[len(PROGRAM):]))
        if window is None:
            raise RuntimeError("the trace holds no %r range" % tracing.WINDOW)
        w0, w1, wtid = window
        self.window_s = (w1 - w0) * 1e-9
        for rs in ranges.values():
            # an outer range before the inner one that opens with it
            rs.sort(key=lambda r: (r[0], -r[1]))
        table = {}
        for rs in ranges.values():
            for s, _, name in rs:
                if w0 <= s <= w1:
                    table.setdefault(name, [0, 0.0, 0])[0] += 1
        # device operations by launching thread, each at its launch
        dev = [d for d in dev if not (d[1] < w0 or d[0] > w1)]
        by_thread = {}
        for s, e, link in dev:
            at = launch.get(link) if link else None
            if at is None:
                row = table.setdefault(UNLINKED, [0, 0.0, 0])
                row[1] += (e - s) * 1e-9
                row[2] += 1
            else:
                by_thread.setdefault(at[1], []).append(
                    (at[0], (e - s) * 1e-9))
        for tid, ops in by_thread.items():
            ops.sort()
            stacks = _stacks_at(ranges.get(tid, []), [t for t, _ in ops])
            for (_, dur), st in zip(ops, stacks):
                row = table.setdefault(owner(st), [0, 0.0, 0])
                row[1] += dur
                row[2] += 1
        self.table = table
        self.device_ops = len(dev)
        self.device_s = sum((e - s) * 1e-9 for s, e, _ in dev)
        self.idle = self._idle(dev, ranges.get(wtid, []), w0, w1)
        self.program_idle_s = sum(v for k, v in self.idle.items()
                                  if k != NO_SPAN)

    @staticmethod
    def _idle(dev, ranges, w0, w1):
        """``{span: seconds}`` of the window's idle stretches (no device
        operation running), by the innermost program span of
        ``ranges`` open on the host."""
        gaps = []
        last = w0
        for s, e, _ in sorted(dev):
            s, e = max(s, w0), min(e, w1)
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if last < w1:
            gaps.append((last, w1))
        # the host's span timeline: constant between range boundaries
        cuts = sorted({w0, w1} | {t for r in ranges for t in r[:2]
                                  if w0 < t < w1})
        mids = [(a + b) / 2 for a, b in zip(cuts, cuts[1:])]
        owners = [owner(st) for st in _stacks_at(ranges, mids)]
        idle = {}
        j = 0
        for a, b in gaps:
            while j < len(mids) and cuts[j + 1] <= a:
                j += 1
            k = j
            while k < len(mids) and cuts[k] < b:
                part = min(b, cuts[k + 1]) - max(a, cuts[k])
                if part > 0:
                    idle[owners[k]] = idle.get(owners[k], 0.0) + part * 1e-9
                k += 1
        return idle

    def layer_share(self):
        """Percent of the window's device time launched under a layer's
        span (not only under the engine's, nor outside every span)."""
        if self.device_s <= 0:
            return None
        under = sum(v[1] for k, v in self.table.items() if is_layer(k))
        return 100.0 * under / self.device_s

    def line(self, passes):
        """The ``spans:`` line: each span's calls, device milliseconds,
        operations and idle milliseconds a pass, the share under a layer
        span and the rest named."""
        n = max(1, passes)
        rows = {k: [v[0] / n, 1e3 * v[1] / n, v[2] / n,
                    1e3 * self.idle.get(k, 0.0) / n]
                for k, v in sorted(self.table.items(),
                                   key=lambda kv: -kv[1][1])}
        for k, v in self.idle.items():
            rows.setdefault(k, [0.0, 0.0, 0.0, 1e3 * v / n])
        rest = {k: v[1] for k, v in self.table.items()
                if v[1] and not is_layer(k)}
        return ("spans: per pass of %d: [calls, device ms, ops, idle ms] %s; "
                "device %.6f s in %d ops of a %.6f s window, %s%% under a "
                "layer span, the rest (s) %s; idle in spans %.6f s, outside "
                "%.6f s; device-side bolt ranges %d"
                % (passes, rows, self.device_s, self.device_ops,
                   self.window_s, self.layer_share(), rest,
                   self.program_idle_s, self.idle.get(NO_SPAN, 0.0),
                   self.device_ranges))


def _thread(e):
    get = getattr(e, "start_thread_id", None)
    return get() if get is not None else 0


def _profiler_events(ctx):
    """The events of the stopped profiler of the run whose reader holds
    ``ctx``: the caller's frame that holds ``ctx`` holds ``prof``; None
    where none does."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if loc.get("ctx") is ctx and loc.get("prof") is not None:
            return loc["prof"].profiler.kineto_results.events()
        f = f.f_back
    return None


def of(ctx):
    """The :class:`Spans` of the traced window ``ctx`` reads (a
    ``harness.MetricContext``), built once, its ``spans:`` line written
    to standard error; None where the run has no device trace."""
    if ctx.trace is None:
        return None
    if not hasattr(ctx, "program_spans"):
        events = _profiler_events(ctx)
        ctx.program_spans = Spans(events) if events is not None else None
        if ctx.program_spans is not None:
            print(ctx.program_spans.line(ctx.passes), file=sys.stderr)
    return ctx.program_spans
