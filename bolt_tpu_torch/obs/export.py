"""Exporters for the span ring: Chrome trace-event JSON and a text tree.

* :func:`to_chrome` — the Trace Event Format (``B``/``E`` duration pairs
  + ``i`` instants + thread-name metadata) that ``chrome://tracing`` and
  Perfetto load directly; a streamed reduction exported here SHOWS its
  ingest spans overlapping compute spans on separate thread tracks —
  the visual twin of ``profile.overlap_efficiency()``.
* :func:`report` — an aggregated plain-text tree (span name -> calls,
  total/self seconds, bytes, kernel compiles beneath it) for terminals
  without a trace viewer.
* :func:`timeline` — the one-shot scope: arm tracing, run, write the
  file::

      with bolt_tpu_torch.obs.timeline("run.json"):
          bolt.fromiter(blocks, shape, mode="gpu", dtype="f4").sum()

Standard library only (json/contextlib); spans come from
:mod:`bolt_tpu_torch.obs.trace`.
"""

import contextlib
import json
import os

from bolt_tpu_torch.obs import trace as _trace


def _events(spans):
    """Flatten spans into trace events.  Tie-breaking on equal
    timestamps keeps nesting well-formed: ends sort before begins (a
    span may end exactly where the next begins), child ends before
    parent ends (descending sid — children have larger sids), parent
    begins before child begins (ascending sid)."""
    if not spans:
        return []
    pid = os.getpid()
    origin = min(s.t0 for s in spans)
    evs = []
    threads = {}
    for s in spans:
        threads.setdefault(s.tid, s.tname)
        ts = (s.t0 - origin) * 1e6
        args = {k: v for k, v in s.attrs.items()
                if isinstance(v, (int, float, str, bool))}
        if s.kind == "I":
            evs.append((ts, 1, s.sid,
                        {"name": s.name, "ph": "i", "s": "t", "ts": ts,
                         "pid": pid, "tid": s.tid, "args": args}))
            continue
        t1 = s.t1 if s.t1 is not None else s.t0
        te = (t1 - origin) * 1e6
        evs.append((ts, 1, s.sid,
                    {"name": s.name, "ph": "B", "ts": ts, "pid": pid,
                     "tid": s.tid, "args": args}))
        evs.append((te, 0, -s.sid,
                    {"name": s.name, "ph": "E", "ts": te, "pid": pid,
                     "tid": s.tid}))
    evs.sort(key=lambda e: e[:3])
    out = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": tname}} for tid, tname in threads.items()]
    out.extend(e[3] for e in evs)
    return out


def to_chrome(spans=None, path=None):
    """Chrome trace-event document for ``spans`` (default: the current
    ring).  Returns the document dict; writes JSON to ``path`` when
    given."""
    doc = {"traceEvents": _events(_trace.spans() if spans is None
                                  else spans),
           "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
    return doc


class _Agg:
    __slots__ = ("count", "total", "self_s", "nbytes", "compiles",
                 "children")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.self_s = 0.0
        self.nbytes = 0
        self.compiles = 0
        self.children = {}


def _aggregate(spans):
    idx = {s.sid: s for s in spans}
    kids = {}
    roots = []
    for s in spans:
        if s.pid and s.pid in idx:
            kids.setdefault(s.pid, []).append(s)
        else:
            roots.append(s)

    def visit(s, node_map):
        agg = node_map.get(s.name)
        if agg is None:
            agg = node_map[s.name] = _Agg()
        d = s.duration or 0.0
        agg.count += 1
        agg.total += d
        ch = kids.get(s.sid, ())
        # self time subtracts only SAME-thread children: spans handed
        # off to another thread (prefetch ingest under a stream run)
        # overlap their parent's own work rather than displacing it
        agg.self_s += d - sum(c.duration or 0.0 for c in ch
                              if c.tid == s.tid)
        b = s.attrs.get("bytes")
        if isinstance(b, (int, float)):
            agg.nbytes += int(b)
        n_comp = 1 if s.name == "engine.compile" else 0
        for c in ch:
            n_comp += visit(c, agg.children)
        agg.compiles += n_comp
        return n_comp

    top = {}
    for r in roots:
        visit(r, top)
    return top


def _human_bytes(n):
    if not n:
        return ""
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return ("%d%s" % (n, unit)) if unit == "B" \
                else ("%.1f%s" % (n, unit))
        n /= 1024.0
    return ""


def report(spans=None):
    """Aggregated text tree over the completed spans: per name (within
    its parent) the call count, total and self wall seconds, summed
    ``bytes`` attrs, and the number of kernel compiles
    (``engine.compile`` spans: ``nvcc`` builds) at or beneath it."""
    sp = _trace.spans() if spans is None else spans
    if not sp:
        return "(no spans recorded — arm tracing with bolt_tpu_torch.obs." \
               "enable() or the obs.timeline(path) scope)"
    top = _aggregate(sp)
    lines = ["%-44s %7s %10s %10s %10s %8s"
             % ("span", "calls", "total_s", "self_s", "bytes",
                "compiles")]

    def render(node_map, depth):
        for name, agg in sorted(node_map.items(),
                                key=lambda kv: -kv[1].total):
            label = "  " * depth + name
            lines.append("%-44s %7d %10.4f %10.4f %10s %8d"
                         % (label[:44], agg.count, agg.total, agg.self_s,
                            _human_bytes(agg.nbytes), agg.compiles))
            render(agg.children, depth + 1)

    render(top, 0)
    return "\n".join(lines)


def trace_arg(argv):
    """Parse the conventional ``--trace out.json`` / ``--trace=out.json``
    CLI flag (the ONE parser both ``scripts/bench_all.py`` and
    ``scripts/perf_regress.py`` use); returns the path or ``None``."""
    for i, a in enumerate(argv):
        if a == "--trace" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--trace="):
            return a.split("=", 1)[1]
    return None


@contextlib.contextmanager
def timeline(path, ring=None):
    """Arm tracing, run the body, write a Chrome trace to ``path`` —
    even when the body raises (the timeline of a failed run is usually
    the point).  Restores the tracer's previous armed/disarmed state;
    the ring keeps the run's spans for :func:`report` afterwards."""
    was_on = _trace.enabled()
    _trace.clear()
    if ring is not None:
        _trace.enable(ring=ring)
    else:
        _trace.enable()
    try:
        yield
    finally:
        if not was_on:
            _trace.disable()
        to_chrome(path=path)
