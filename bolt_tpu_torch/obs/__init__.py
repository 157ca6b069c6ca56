"""bolt_tpu_torch.obs — structured tracing, metrics and timeline export.

Port of ``bolt_tpu/obs``: one place to see where a pipeline spends its
time — program builds vs dispatch vs transfer vs overlap — without
reading engine internals.

* :mod:`bolt_tpu_torch.obs.trace` — thread-safe span tracer.  ``obs.span``
  is the context-manager/decorator API; ``obs.begin``/``obs.end`` the
  allocation-free hot-path pair the engine and streaming executor use;
  ``obs.event`` instant marks; ``obs.clock`` THE blessed monotonic
  timer.  Off by default; near-zero
  cost while off.
* :mod:`bolt_tpu_torch.obs.metrics` — typed registry (counters, gauges,
  log2-bucket histograms, locked counter groups).  The dispatch
  engine's counters are the group named ``"engine"`` here;
  ``profile.engine_counters()`` is a facade over it.
* :mod:`bolt_tpu_torch.obs.export` — ``obs.to_chrome`` (Perfetto/
  ``chrome://tracing`` JSON), ``obs.report`` (text tree), and the
  ``obs.timeline(path)`` scope that arms tracing around one run and
  writes the file.

Quick start::

    import bolt_tpu_torch as bolt
    with bolt.obs.timeline("run.json"):
        bolt.fromcallback(load, shape, mode="gpu", dtype="f4").sum()
    print(bolt.obs.report())

The obs modules themselves import ONLY the standard library (no torch,
no numpy — ``trace.py``/``metrics.py`` load standalone by path);
reaching them through the ``bolt_tpu_torch`` package of course
initialises the package as usual.
"""

from bolt_tpu_torch.obs import metrics
from bolt_tpu_torch.obs.export import report, timeline, to_chrome, trace_arg
from bolt_tpu_torch.obs.metrics import registry, thread_census
from bolt_tpu_torch.obs.trace import (Span, active_count, begin, cancel, clear,
                                clock, current, disable, enable, enabled,
                                end, event, span, spans)

__all__ = ["Span", "active_count", "begin", "cancel", "clear", "clock",
           "current", "disable", "enable", "enabled", "end", "event",
           "metrics", "registry", "report", "span", "spans",
           "thread_census", "timeline", "to_chrome", "trace_arg"]
