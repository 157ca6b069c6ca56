"""AST-based repo invariant linter (port of
``bolt_tpu/analysis/astlint.py``): the codebase rules of
``bolt_tpu_torch`` enforced mechanically.

Rules (the ``BLT1xx`` range; the abstract pipeline checker owns
``BLT0xx`` — see :mod:`bolt_tpu_torch.analysis.diagnostics`).  Where the
reference names a jax API, the rule names its torch counterpart:

* **BLT101** — no ``torch.compile`` or ``torch.jit.*`` outside
  ``engine.py``, except inside a *builder* — a function or lambda
  passed to ``_cached_jit(key, builder)`` / ``engine.get(key,
  builder)``, whose product the engine owns (build counters, the
  program cache, the dispatch order).
* **BLT102** — no private or version-sensitive torch namespace
  (``torch._C``, ``torch._subclasses``, ``torch._dynamo``,
  ``torch._prims``, any ``torch._*`` module) outside the modules that
  use one today, each exempt for its stated reason (``_EXEMPT``).
* **BLT103** — no TF32 / matmul-precision switch
  (``torch.backends.*.allow_tf32 = ...``,
  ``torch.set_float32_matmul_precision``) and no ``precision=`` literal
  at a call site outside ``_precision.py``: matmul-class precision
  routes through ``_precision.resolve()`` and the scoped
  ``bolt.precision(...)`` policy.  Function *defaults*
  (``def f(..., precision="highest")``) are allowed.
* **BLT104** — no ``._concrete`` access outside ``gpu/array.py``.
  Reads go through ``._data``, which runs the ``_guard_donated``
  donation gate.
* **BLT105** — no ``non_blocking=True`` host→device copy outside
  ``stream.py``: uploads go through ``stream.transfer`` and the
  executor's pinned ring, which count ``transfer_bytes`` and own the
  copy streams and events.
* **BLT106** — no raw ``time.perf_counter()`` outside ``obs/`` and
  ``profile.py``: durations come from ``bolt_tpu_torch.obs``.
* **BLT107** — no ``torch.cuda.synchronize`` and no stream's or
  event's ``.synchronize()`` outside ``stream.py``, ``engine.py`` and
  ``profile.py``: a stray sync serialises the async dispatch pipeline.
* **BLT108** — no raw ``threading.Thread`` / pool-executor
  construction outside ``stream.py`` (the uploader pool) and
  ``serve.py`` (the scheduler).
* **BLT109** — no ``os.kill``/``signal`` use outside ``_chaos.py``,
  tests and scripts.
* **BLT110** — no ``torch.distributed`` outside
  ``parallel/multihost.py`` (the one home of process topology; the
  port has no such module yet, so every use is a finding).

A finding on line *N* is suppressed when that line carries a
``# lint: allow(BLT1xx <reason>)`` pragma.

This module imports ONLY the standard library, so
``bolt_tpu_torch/analysis/lint.py`` runs with no torch import (about two
seconds over the package, most of it parsing and walking the trees).
"""

import ast
import os

RULES = {
    "BLT101": "torch.compile / torch.jit outside the engine build path",
    "BLT102": "private or version-sensitive torch namespace outside its "
              "exempt modules",
    "BLT103": "TF32/matmul-precision switch or precision= literal "
              "bypassing _precision",
    "BLT104": "._concrete access bypassing the _guard_donated gate",
    "BLT105": "non_blocking host->device copy outside the stream "
              "transfer layer",
    "BLT106": "raw time.perf_counter bookkeeping outside bolt_tpu_torch.obs",
    "BLT107": "stray CUDA synchronize outside the executor",
    "BLT108": "raw thread/executor construction outside stream.py/serve.py",
    "BLT109": "os.kill/signal fault injection outside the chaos seams",
    "BLT110": "torch.distributed outside parallel/multihost.py",
}

# rule -> path suffixes (os-normalised) exempt from it; an entry ending
# with the path separator exempts every file under a directory of that
# name (e.g. the whole obs/ subsystem)
_EXEMPT = {
    "BLT101": ("engine.py",),
    "BLT102": (
        # the launch wrappers pass the current raw CUDA stream to the
        # ctypes-bound kernels (torch._C._cuda_getCurrentRawStream)
        os.path.join("ops", "kernels.py"),
        # _use_jacobi counts vmapped levels through torch._C._functorch
        os.path.join("ops", "linalg.py"),
        # donation counts a storage's holders (torch._C._storage_Use_Count)
        os.path.join("gpu", "array.py"),
    ),
    "BLT103": ("_precision.py",),
    "BLT104": (os.path.join("gpu", "array.py"),),
    # stream.transfer and the pinned ring ARE the counted upload path
    "BLT105": ("stream.py",),
    # obs owns the clock; profile.py is the user-facing timing facade
    "BLT106": ("obs" + os.sep, "profile.py"),
    # the executor's transfer/window syncs, the engine, and profile's
    # timing barriers are the sanctioned sync points
    "BLT107": ("stream.py", "engine.py", "profile.py"),
    # the blessed concurrency homes: the uploader pool and the
    # multi-tenant scheduler
    "BLT108": ("stream.py", "serve.py"),
    # the one blessed fault-injection home (plus tests/scripts)
    "BLT109": ("_chaos.py", "tests" + os.sep, "scripts" + os.sep),
    # the one blessed process-topology home (plus tests/scripts, which
    # stand up their own clusters)
    "BLT110": (os.path.join("parallel", "multihost.py"),
               "tests" + os.sep, "scripts" + os.sep),
}

# process-signal fault calls BLT109 forbids outside the blessed seams
_FAULT_CALLS = {
    "os.kill",
    "os.killpg",
    "os.abort",
    "signal.signal",
    "signal.raise_signal",
    "signal.pthread_kill",
    "signal.setitimer",
    "signal.alarm",
}

# constructors BLT108 forbids outside the blessed homes
_THREAD_CONSTRUCTORS = {
    "threading.Thread",
    "threading.Timer",
    "concurrent.futures.ThreadPoolExecutor",
    "concurrent.futures.ProcessPoolExecutor",
    "concurrent.futures.thread.ThreadPoolExecutor",
    "concurrent.futures.process.ProcessPoolExecutor",
    "multiprocessing.pool.ThreadPool",
    "multiprocessing.pool.Pool",
    "multiprocessing.Process",
}

# the matmul-precision switches BLT103 confines to _precision.py
_PRECISION_CALLS = {"torch.set_float32_matmul_precision"}
_PRECISION_FLAGS = {"allow_tf32", "allow_bf16_reduced_precision_reduction",
                    "allow_fp16_reduced_precision_reduction"}

# call names whose second argument is an engine builder
_BUILDER_SINKS = {"_cached_jit"}
_BUILDER_SINK_ATTRS = {"engine.get", "_engine.get"}


class Finding:
    """One linter finding: ``code``, ``path``, ``line``/``col`` and a
    message (plus the rule's one-line title)."""

    __slots__ = ("code", "path", "line", "col", "message")

    def __init__(self, code, path, line, col, message):
        self.code = code
        self.path = path
        self.line = line
        self.col = col
        self.message = message

    @property
    def title(self):
        return RULES[self.code]

    def render(self):
        return "%s:%d:%d: %s %s" % (self.path, self.line, self.col,
                                    self.code, self.message)

    def __repr__(self):
        return "<Finding %s %s:%d>" % (self.code, self.path, self.line)


def _dotted(node):
    """``a.b.c`` attribute/name chain as a dotted string (or None)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _exempt(code, path, table=None):
    """Suffix match ANCHORED on a path separator: ``upstream.py`` must
    not inherit ``stream.py``'s exemption.  Directory entries (trailing
    separator) exempt any file under a component of that exact name."""
    norm = os.path.normpath(path)
    for suffix in (table or _EXEMPT)[code]:
        if suffix.endswith(os.sep):
            if (os.sep + suffix) in (os.sep + norm) \
                    or norm.startswith(suffix):
                return True
        elif norm == suffix or norm.endswith(os.sep + suffix):
            return True
    return False


def _builder_regions(tree):
    """Line spans of every function/lambda passed as the builder
    argument to ``_cached_jit``/``engine.get``.  Name builders resolve
    within the ENCLOSING function scope of the sink call."""
    spans = []
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    def scope_of(node):
        while node in parents:
            node = parents[node]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.Module)):
                return node
        return tree

    defs = {}                   # scope -> [FunctionDef], built once

    def defs_in(scope):
        if scope not in defs:
            defs[scope] = [c for c in ast.walk(scope)
                           if isinstance(c, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
        return defs[scope]

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        is_sink = (isinstance(fn, ast.Name) and fn.id in _BUILDER_SINKS) \
            or (_dotted(fn) in _BUILDER_SINK_ATTRS)
        if not is_sink or len(node.args) < 2:
            continue
        builder = node.args[1]
        if isinstance(builder, ast.Lambda):
            spans.append((builder.lineno, builder.end_lineno))
        elif isinstance(builder, ast.Name):
            spans.extend((c.lineno, c.end_lineno)
                         for c in defs_in(scope_of(node))
                         if c.name == builder.id)
    return spans


def _in_spans(line, spans):
    return any(lo <= line <= hi for lo, hi in spans)


def _pragma_lines(src):
    """Line numbers carrying a ``lint: allow(CODE ...)`` pragma, mapped
    to the allowed code."""
    allowed = {}
    for i, line in enumerate(src.splitlines(), start=1):
        if "lint: allow(" not in line:
            continue
        frag = line.split("lint: allow(", 1)[1]
        code = frag.split()[0].rstrip(")") if frag.split() else ""
        allowed[i] = code
    return allowed


def _aliases(tree):
    """Import aliases: local name -> dotted origin (``from torch import
    cuda`` AND ``import time as _time``)."""
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = "%s.%s" % (node.module,
                                                         a.name)
    return aliases


def _resolver(aliases):
    def resolved(node):
        """Dotted chain with the leading import alias expanded."""
        dotted = _dotted(node)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        origin = aliases.get(head)
        if origin:
            return origin + ("." + rest if rest else "")
        return dotted
    return resolved


def _private_torch(dotted):
    """The private torch module a dotted chain reaches (``torch._C``),
    or None."""
    if not dotted or not dotted.startswith("torch."):
        return None
    sub = dotted.split(".")[1]
    if sub.startswith("_") and not sub.startswith("__"):
        return "torch." + sub
    return None


def _is_true(node):
    return isinstance(node, ast.Constant) and node.value is True


def lint_source(src, path="<string>"):
    """Lint one module's source text; returns a list of
    :class:`Finding` (sorted by line)."""
    tree = ast.parse(src, filename=path)
    pragmas = _pragma_lines(src)
    findings = []
    seen = set()

    def emit(code, node, message):
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        if _exempt(code, path) or pragmas.get(line) == code:
            return
        if (code, line, col) in seen:
            return
        seen.add((code, line, col))
        findings.append(Finding(code, path, line, col, message))

    builder_spans = _builder_regions(tree)
    resolved = _resolver(_aliases(tree))

    # attribute chains already reported through their outermost node
    inner = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            inner.add(id(node.value))

    for node in ast.walk(tree):
        # ---- imports: BLT102 / BLT109 / BLT110 -------------------------
        if isinstance(node, ast.Import):
            for a in node.names:
                priv = _private_torch(a.name)
                if priv:
                    emit("BLT102", node,
                         "import of %s, a private torch namespace; keep it "
                         "to the exempt modules" % priv)
                if a.name == "signal" or a.name.startswith("signal."):
                    emit("BLT109", node,
                         "import of the signal module outside the blessed "
                         "fault seams; fault injection lives in "
                         "bolt_tpu_torch._chaos (lint rule BLT109)")
                if a.name == "torch.distributed" \
                        or a.name.startswith("torch.distributed."):
                    emit("BLT110", node,
                         "import of torch.distributed outside the blessed "
                         "topology home (parallel/multihost.py)")
        if isinstance(node, ast.ImportFrom) and node.module:
            priv = _private_torch(node.module) or next(
                (p for p in (_private_torch("%s.%s" % (node.module, a.name))
                             for a in node.names) if p), None)
            if priv:
                emit("BLT102", node,
                     "import from %s, a private torch namespace; keep it "
                     "to the exempt modules" % priv)
            if node.module == "signal":
                emit("BLT109", node,
                     "import from the signal module outside the blessed "
                     "fault seams; fault injection lives in "
                     "bolt_tpu_torch._chaos (lint rule BLT109)")
            if node.module == "torch.distributed" \
                    or node.module.startswith("torch.distributed.") \
                    or (node.module == "torch"
                        and any(a.name == "distributed"
                                for a in node.names)):
                emit("BLT110", node,
                     "import of torch.distributed outside the blessed "
                     "topology home (parallel/multihost.py)")

        # ---- BLT101: torch.compile / torch.jit -------------------------
        comp = []
        if isinstance(node, ast.Call):
            name = resolved(node.func) or ""
            if name == "torch.compile" or name.startswith("torch.jit."):
                comp.append((node, name))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                name = resolved(dec) or ""
                if not isinstance(dec, ast.Call) and (
                        name == "torch.compile"
                        or name.startswith("torch.jit.")):
                    comp.append((dec, name))
        for cn, name in comp:
            if not _in_spans(cn.lineno, builder_spans):
                emit("BLT101", cn,
                     "%s outside the engine's build path; return the "
                     "compiled callable from a builder passed to "
                     "_cached_jit/engine.get" % name)

        # ---- BLT102 / BLT110: attribute chains -------------------------
        if isinstance(node, ast.Attribute) and id(node) not in inner:
            dotted = resolved(node) or ""
            priv = _private_torch(dotted)
            if priv:
                emit("BLT102", node,
                     "%s is a private torch namespace (its API changes "
                     "between releases); keep it to the exempt modules"
                     % priv)
            if dotted == "torch.distributed" \
                    or dotted.startswith("torch.distributed."):
                emit("BLT110", node,
                     "torch.distributed outside the blessed topology "
                     "home (parallel/multihost.py)")

        # ---- BLT103: precision switches and literals -------------------
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and t.attr in _PRECISION_FLAGS:
                    emit("BLT103", t,
                         "%s switched outside _precision.py; scope the "
                         "matmul precision with bolt_tpu_torch.precision"
                         "(...)" % (_dotted(t) or t.attr))
        if isinstance(node, ast.Call):
            if resolved(node.func) in _PRECISION_CALLS:
                emit("BLT103", node,
                     "%s outside _precision.py; scope the matmul "
                     "precision with bolt_tpu_torch.precision(...)"
                     % resolved(node.func))
            for kw in node.keywords:
                if kw.arg == "precision" and isinstance(
                        kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    emit("BLT103", kw.value,
                         "precision literal at a call site bypasses the "
                         "scoped policy; pass _precision.resolve(...) "
                         "instead (resolve('highest') for a deliberate "
                         "pin)")

        # ---- BLT104: ._concrete outside the donation gate --------------
        if isinstance(node, ast.Attribute) and node.attr == "_concrete":
            emit("BLT104", node,
                 "._concrete bypasses the _guard_donated donation gate; "
                 "read ._data instead")

        # ---- BLT105: non_blocking uploads outside stream.transfer ------
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "non_blocking" and _is_true(kw.value):
                    emit("BLT105", node,
                         "a non_blocking copy bypasses the counted "
                         "transfer layer (transfer_bytes/"
                         "transfer_seconds stay blind, and no event "
                         "fences the pinned source); route it through "
                         "bolt_tpu_torch.stream.transfer")

        # ---- BLT107: stray sync points ---------------------------------
        if isinstance(node, ast.Call):
            name = resolved(node.func) or ""
            if name == "torch.cuda.synchronize" or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "synchronize"):
                emit("BLT107", node,
                     "a synchronize here serialises the async dispatch "
                     "pipeline; let the executor/profiling layers own "
                     "synchronisation")

        # ---- BLT109: os.kill / signal fault injection ------------------
        if isinstance(node, ast.Call) \
                and resolved(node.func) in _FAULT_CALLS:
            emit("BLT109", node,
                 "%s outside the blessed fault seams; route the fault "
                 "through bolt_tpu_torch._chaos.inject/hit" %
                 resolved(node.func))

        # ---- BLT108: raw thread/executor construction ------------------
        if isinstance(node, ast.Call) \
                and resolved(node.func) in _THREAD_CONSTRUCTORS:
            emit("BLT108", node,
                 "%s constructed outside the blessed concurrency homes "
                 "(stream.py's uploader pool, serve.py's scheduler); a "
                 "stray thread bypasses the device-memory arbiter and "
                 "the per-tenant counter scoping" % resolved(node.func))

        # ---- BLT106: raw perf_counter bookkeeping outside obs ----------
        if isinstance(node, ast.Call) \
                and resolved(node.func) == "time.perf_counter":
            emit("BLT106", node,
                 "raw time.perf_counter() keeps its timing off the shared "
                 "clock and the obs timeline; use bolt_tpu_torch.obs."
                 "clock() or obs.span(...)")

    findings.sort(key=lambda f: (f.line, f.col))
    return findings


def lint_file(path):
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def iter_py_files(root):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_paths(paths, lint=None):
    lint = lint or lint_file
    findings = []
    for p in paths:
        if os.path.isdir(p):
            for f in iter_py_files(p):
                findings.extend(lint(f))
        else:
            findings.extend(lint(p))
    return findings


def package_root():
    """The ``bolt_tpu_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_package(root=None):
    """Lint the ``bolt_tpu_torch`` package (zero findings is a tier-1
    invariant — ``tests/test_torch_lint.py``)."""
    return lint_paths([root or package_root()])
