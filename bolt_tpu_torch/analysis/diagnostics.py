"""Structured diagnostics for the abstract pipeline checker (port of
``bolt_tpu/analysis/diagnostics.py``, standard library only).

Every finding the checker (:mod:`bolt_tpu_torch.analysis.check`) emits is
a :class:`Diagnostic` with a stable ``BLT0xx`` code, a severity, the
index of the pipeline stage it anchors to, and a fix hint — the
compiler-style contract the repo linter
(:mod:`bolt_tpu_torch.analysis.astlint`) mirrors with its ``BLT1xx``
range.  The code table is the reference's (``docs/API.md``); the checker
emits BLT004 on a mesh (idle ranks), BLT012 for a pod stream's slab
the key-axis assignment does not divide, BLT013 for a pod stream with no
recovery path and BLT014 for a supervised pod stream a rejoined rank
cannot re-ingest.

Severities:

* ``error``   — the pipeline WILL fail at compile or dispatch time
  (``analysis.strict()`` refuses to dispatch on these);
* ``warning`` — the pipeline runs but something is probably not what the
  author intended (silent dtype widening, idle devices);
* ``info``    — a behavior worth knowing about before dispatch (an
  upcoming buffer donation, a dynamic shape pending a count sync).
"""

# code -> (default severity, short title).  The checker's BLT0xx range;
# the AST linter owns BLT1xx (see astlint.RULES).
CODES = {
    "BLT001": ("error", "pipeline stage fails abstract tracing"),
    "BLT002": ("error", "recorded result aval contradicts the chain"),
    "BLT003": ("warning", "stage widens the pipeline dtype"),
    "BLT004": ("warning", "key axes do not divide the mesh"),
    "BLT005": ("error", "read path hits a donated buffer"),
    "BLT006": ("info", "terminal will donate the chain base"),
    "BLT007": ("error", "filter predicate is not a scalar per record"),
    "BLT008": ("info", "result shape is dynamic until a count sync"),
    "BLT009": ("info", "fusable terminal set: one pass serves N stats"),
    "BLT010": ("error", "pipeline exceeds the serving admission budget"),
    "BLT011": ("warning",
               "one-shot iterator source under resumable(): resume "
               "impossible"),
    "BLT012": ("error",
               "streamed key axis does not divide the multi-process "
               "topology"),
    "BLT013": ("warning",
               "multi-process stream has no recovery path: peer loss "
               "discards all partials"),
    "BLT014": ("warning",
               "supervised pod stream's source cannot serve a rejoined "
               "process: re-expansion impossible for this run"),
    "BLT015": ("info",
               "terminal is batch-eligible: a batching server coalesces "
               "same-key requests into one dispatch"),
    "BLT016": ("info",
               "codec-encoded ingest: streamed slabs ship compressed "
               "and decode on device"),
    "BLT017": ("info",
               "streamed shuffle plan: the swap re-buckets slab by "
               "slab, resident in HBM or spilled past the budget"),
}

SEVERITIES = ("error", "warning", "info")


class Diagnostic:
    """One checker finding: ``code`` (``BLT0xx``), ``severity``,
    ``stage`` (pipeline stage index; ``-1`` for array-level findings),
    ``message`` and a ``hint`` suggesting the fix."""

    __slots__ = ("code", "severity", "stage", "message", "hint")

    def __init__(self, code, stage, message, hint="", severity=None):
        if code not in CODES:
            raise ValueError("unknown diagnostic code %r" % (code,))
        self.code = code
        self.severity = severity or CODES[code][0]
        if self.severity not in SEVERITIES:
            raise ValueError("unknown severity %r" % (self.severity,))
        self.stage = int(stage)
        self.message = message
        self.hint = hint

    def __repr__(self):
        return "Diagnostic(%s %s stage=%d: %s)" % (
            self.code, self.severity, self.stage, self.message)

    def render(self):
        where = "stage %d" % self.stage if self.stage >= 0 else "array"
        out = "%s %-7s %s: %s" % (self.code, self.severity, where,
                                  self.message)
        if self.hint:
            out += "\n        hint: %s" % self.hint
        return out


class Stage:
    """One abstract-interpretation step of a pipeline: the operation
    label, the inferred full (keys+values) ``shape``/``dtype``, the key
    ``split``, and ``spec``, the ``torch.device`` the stage's data lives
    on (the reference's ``PartitionSpec``; one card holds one shard).
    ``dynamic`` marks a leading key extent that is only an upper bound
    (a filter whose survivor count has not been synced); ``note``
    carries free-form context for :func:`explain`."""

    __slots__ = ("index", "op", "shape", "dtype", "split", "spec",
                 "dynamic", "note")

    def __init__(self, index, op, shape, dtype, split, spec=None,
                 dynamic=False, note=""):
        self.index = index
        self.op = op
        self.shape = tuple(shape)
        self.dtype = dtype
        self.split = split
        self.spec = spec
        self.dynamic = dynamic
        self.note = note

    def render(self):
        if self.dynamic:
            shape = "(<=%s)" % ", ".join(str(s) for s in self.shape)
        else:
            shape = str(self.shape)
        out = "stage %d  %-24s %-18s %-10s split=%d" % (
            self.index, self.op, shape, str(self.dtype), self.split)
        if self.spec is not None:
            out += "  device=%s" % (self.spec,)
        if self.note:
            out += "  [%s]" % self.note
        return out


class Report:
    """The checker's result: the per-stage abstract interpretation and
    every diagnostic, plus the predicted terminal ``shape``/``dtype``.

    ``shape`` uses ``None`` for a dynamic leading extent (a pending
    filter count); ``max_shape`` gives the padded upper bound instead.
    ``ok`` is True when no *error*-severity diagnostic was emitted —
    warnings and infos do not fail a pipeline (and do not block
    :func:`bolt_tpu_torch.analysis.strict` dispatch)."""

    __slots__ = ("target", "stages", "diagnostics", "dynamic")

    def __init__(self, target, stages, diagnostics, dynamic=False):
        self.target = target            # "gpu" / "local" / view label
        self.stages = list(stages)
        self.diagnostics = list(diagnostics)
        self.dynamic = bool(dynamic)

    # -- outcome ------------------------------------------------------

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self):
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def infos(self):
        return [d for d in self.diagnostics if d.severity == "info"]

    @property
    def ok(self):
        return not self.errors

    def has(self, code):
        return any(d.code == code for d in self.diagnostics)

    # -- prediction ---------------------------------------------------

    @property
    def shape(self):
        """Predicted result shape; a dynamic (un-synced filter count)
        leading extent reads ``None``."""
        if not self.stages:
            return None
        last = self.stages[-1]
        if last.dynamic:
            return (None,) + tuple(last.shape[1:])
        return tuple(last.shape)

    @property
    def max_shape(self):
        """Predicted shape with dynamic extents at their upper bound."""
        return tuple(self.stages[-1].shape) if self.stages else None

    @property
    def dtype(self):
        return self.stages[-1].dtype if self.stages else None

    @property
    def split(self):
        return self.stages[-1].split if self.stages else None

    def __str__(self):
        lines = ["bolt_tpu_torch.analysis report (%s)" % self.target]
        for s in self.stages:
            lines.append("  " + s.render())
        if self.diagnostics:
            lines.append("diagnostics:")
            for d in self.diagnostics:
                lines.append("  " + d.render())
        lines.append("result: %s"
                     % ("OK" if self.ok
                        else "%d error(s)" % len(self.errors)))
        return "\n".join(lines)

    def __repr__(self):
        return "<analysis.Report %s: %d stage(s), %d diagnostic(s)>" % (
            "ok" if self.ok else "ERRORS", len(self.stages),
            len(self.diagnostics))


class PipelineError(RuntimeError):
    """Raised by a :func:`bolt_tpu_torch.analysis.strict` scope when a
    dispatching terminal's pre-compile check finds error-severity
    diagnostics.  Carries the offending :class:`Report` as ``report``."""

    def __init__(self, op, report):
        self.op = op
        self.report = report
        msgs = "; ".join("%s: %s" % (d.code, d.message)
                         for d in report.errors)
        super().__init__(
            "analysis.strict(): refusing to dispatch %s — %s" % (op, msgs))
