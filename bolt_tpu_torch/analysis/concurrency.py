"""Static concurrency analysis: the lock-hierarchy lint pass (port of
``bolt_tpu/analysis/concurrency.py``).

The runtime lockdep witness (:mod:`bolt_tpu_torch._lockdep`) catches the
inversions a test actually EXECUTES; this pass catches the ones it
doesn't — every lock creation and every lexically-nested acquisition in
the package is checked against the declared rank table without running
a thread.

Rules (continuing the ``BLT1xx`` range of
:mod:`bolt_tpu_torch.analysis.astlint`):

* **BLT111** — a lock created outside the declared inventory: raw
  ``threading.Lock()`` / ``RLock()`` / ``Condition()`` in package code,
  or a ``_lockdep.lock/rlock/condition(name)`` whose ``name`` is not a
  string literal in ``_lockdep.RANKS``.
* **BLT112** — a static acquisition-order inversion: a ``with`` block
  acquiring a ranked lock lexically inside a ``with`` holding an
  equal-or-higher-ranked one.
* **BLT113** — an indefinite blocking call (``Future.result()``,
  ``queue.get()``, ``wait()``/``join()`` without a timeout,
  ``time.sleep``, a barrier) lexically under a ranked lock.
* **BLT114** — a raw program enqueue outside ``with order_lock():``.
  ``engine.get`` returns a dispatch wrapper whose call takes the order
  lock itself; the port's raw enqueue is calling the built program
  directly — ``<dispatch>.fn(...)``, or a name bound from
  ``<dispatch>.fn`` — which bypasses the lock, so one process's
  programs could interleave their launches.

A finding on line *N* is suppressed by ``# lint: allow(BLT11x
<reason>)`` on that line.  The pass reasons about one module and about
*lexical* nesting only: a nested ``def`` resets the held-lock stack.
It loads the rank table from ``bolt_tpu_torch/_lockdep.py`` by path
(standard library only), so the lint path imports no torch.
"""

import ast
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def _load(modname, path):
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod
    import importlib.util
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    # registered BEFORE exec so a later package import adopts this
    # instance (one rank table, one RULES registry, process-wide)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


_astlint = _load("bolt_tpu_torch.analysis.astlint",
                 os.path.join(_HERE, "astlint.py"))
_lockdep = _load("bolt_tpu_torch._lockdep",
                 os.path.join(os.path.dirname(_HERE), "_lockdep.py"))

Finding = _astlint.Finding
_dotted = _astlint._dotted
_pragma_lines = _astlint._pragma_lines
iter_py_files = _astlint.iter_py_files

RANKS = _lockdep.RANKS

RULES = {
    "BLT111": "lock created outside the declared _lockdep inventory",
    "BLT112": "static lock-acquisition order inversion",
    "BLT113": "indefinite blocking call while holding a ranked lock",
    "BLT114": "raw program enqueue outside the engine order lock",
}

# one BLT1xx namespace: Finding.title and the --codes table resolve
# through the astlint registry
_astlint.RULES.update(RULES)

_EXEMPT = {
    # the witness constructs the raw primitives it wraps; tests and
    # scripts build scratch locks for their own harnesses
    "BLT111": ("_lockdep.py", "tests" + os.sep, "scripts" + os.sep),
    "BLT112": ("_lockdep.py", "tests" + os.sep, "scripts" + os.sep),
    "BLT113": ("_lockdep.py", "tests" + os.sep, "scripts" + os.sep),
    "BLT114": ("tests" + os.sep, "scripts" + os.sep),
}

_RAW_LOCKS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
}

_FACTORY_TAILS = {"lock", "rlock", "condition"}

# dotted tails that block indefinitely regardless of arguments
_BLOCKING_TAILS = {"barrier", "wait_ready"}

# attribute calls that block indefinitely ONLY with no timeout at all
_BLOCKING_IF_BARE = {"wait", "result", "join", "get", "acquire"}


def _is_lockdep_factory(resolved_name):
    """True for any import spelling of the inventory factories."""
    if resolved_name is None:
        return False
    head, _, tail = resolved_name.rpartition(".")
    return tail in _FACTORY_TAILS and head.endswith("_lockdep")


def _lock_bindings(tree, resolved):
    """``names`` (``X = _lockdep.lock("n")``) and ``attrs``
    (``self.x = _lockdep.rlock("n")``) resolving lock expressions to
    inventory names."""
    names, attrs = {}, {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        val = node.value
        if not (isinstance(val, ast.Call)
                and _is_lockdep_factory(resolved(val.func))
                and val.args
                and isinstance(val.args[0], ast.Constant)
                and isinstance(val.args[0].value, str)):
            continue
        inv = val.args[0].value
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name):
            names[tgt.id] = inv
        elif isinstance(tgt, ast.Attribute):
            attrs[tgt.attr] = inv
    return names, attrs


def _with_item_name(expr, resolved, names, attrs):
    """Inventory name a ``with <expr>:`` item acquires, or None (an
    unresolvable expression is skipped, never guessed)."""
    if isinstance(expr, ast.Call):
        dotted = resolved(expr.func) or ""
        if dotted == "order_lock" or dotted.endswith(".order_lock"):
            return "engine.order"
        return None
    if isinstance(expr, ast.Name):
        return names.get(expr.id)
    if isinstance(expr, ast.Attribute):
        return attrs.get(expr.attr)
    return None


def _enqueue_names(fn_node):
    """Local names in ``fn_node`` bound from a dispatch's raw program
    (``raw = entry.fn``), whose later CALL is an enqueue (BLT114)."""
    out = set()
    todo = list(ast.iter_child_nodes(fn_node))
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue            # a nested def binds its own names
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr == "fn":
            out.add(node.targets[0].id)
        todo.extend(ast.iter_child_nodes(node))
    return out


def _is_blocking(node, resolved):
    """Message for a call that can block indefinitely, or None."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr in _BLOCKING_TAILS:
            return "%s() is a collective/rendezvous" % fn.attr
        if fn.attr in _BLOCKING_IF_BARE and not node.args \
                and not node.keywords:
            return ".%s() with no timeout blocks indefinitely" % fn.attr
    if resolved(fn) == "time.sleep":
        return "time.sleep() parks the thread"
    return None


def lint_source(src, path="<string>"):
    """Run BLT111–BLT114 over one module's source; returns sorted
    :class:`Finding` objects."""
    tree = ast.parse(src, filename=path)
    pragmas = _pragma_lines(src)
    findings = []

    def emit(code, node, message):
        line = getattr(node, "lineno", 0)
        if _astlint._exempt(code, path, _EXEMPT) \
                or pragmas.get(line) == code:
            return
        findings.append(Finding(code, path, line,
                                getattr(node, "col_offset", 0), message))

    resolved = _astlint._resolver(_astlint._aliases(tree))
    names, attrs = _lock_bindings(tree, resolved)

    # ---- BLT111: creation sites ------------------------------------
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = resolved(node.func)
        if dotted in _RAW_LOCKS:
            emit("BLT111", node,
                 "raw %s() is invisible to the lock-hierarchy witness; "
                 "construct it through bolt_tpu_torch._lockdep."
                 "lock/rlock/condition(name) with a declared inventory "
                 "name" % dotted)
        elif _is_lockdep_factory(dotted):
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                emit("BLT111", node,
                     "lock inventory name must be a string literal so "
                     "the static pass can rank it")
            elif arg.value not in RANKS:
                emit("BLT111", node,
                     "lock name %r is not in the declared inventory "
                     "(_lockdep.RANKS); add it with a rank reflecting "
                     "its nesting depth" % arg.value)

    # ---- BLT112/113/114: the held-stack walk -----------------------
    def walk(node, held, enqueue):
        # a nested function's body runs LATER, not under the lock
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            enq = enqueue | _enqueue_names(node)
            for child in ast.iter_child_nodes(node):
                walk(child, [], enq)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in node.items:
                inv = _with_item_name(item.context_expr, resolved,
                                      names, attrs)
                rank = RANKS.get(inv) if inv is not None else None
                if rank is None:
                    continue
                for outer_name, outer_rank in held + acquired:
                    if outer_rank >= rank and outer_name != inv:
                        emit("BLT112", item.context_expr,
                             "acquiring %r (rank %d) inside %r (rank "
                             "%d) inverts the declared order; "
                             "restructure so the lower rank is taken "
                             "first, or re-rank the inventory"
                             % (inv, rank, outer_name, outer_rank))
                acquired.append((inv, rank))
            inner = held + acquired
            for child in node.body:
                walk(child, inner, enqueue)
            return
        if isinstance(node, ast.Call):
            if held:
                why = _is_blocking(node, resolved)
                if why is not None:
                    emit("BLT113", node,
                         "%s while holding %r — every thread "
                         "contending that lock stalls for the full "
                         "wait; release the lock first or bound the "
                         "wait" % (why, held[-1][0]))
            fn = node.func
            is_enqueue = (isinstance(fn, ast.Attribute)
                          and fn.attr == "fn") \
                or (isinstance(fn, ast.Name) and fn.id in enqueue)
            if is_enqueue \
                    and not any(n == "engine.order" for n, _ in held):
                emit("BLT114", node,
                     "raw program enqueue outside `with order_lock():` — "
                     "call the dispatch engine.get returned (it takes "
                     "the order lock), not its .fn, so one process's "
                     "programs never interleave their launches")
        for child in ast.iter_child_nodes(node):
            walk(child, held, enqueue)

    walk(tree, [], set())
    findings.sort(key=lambda f: (f.line, f.col))
    return findings


def lint_file(path):
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths):
    return _astlint.lint_paths(paths, lint=lint_file)


def lint_package(root=None):
    """Run the concurrency pass over ``bolt_tpu_torch`` (zero findings is
    a tier-1 invariant, as for the astlint pass)."""
    return lint_paths([root or _astlint.package_root()])
