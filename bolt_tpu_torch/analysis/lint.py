#!/usr/bin/env python
"""Repo invariant linter CLI for ``bolt_tpu_torch`` — the ``BLT1xx`` AST
rules of ``astlint.py`` plus the concurrency pass of ``concurrency.py``
as a fast standalone gate (the port's counterpart of
``scripts/lint_bolt.py``)::

    python bolt_tpu_torch/analysis/lint.py               # both passes
    python bolt_tpu_torch/analysis/lint.py --check       # exit 1 on
                                                         # findings OR
                                                         # stale pragmas
    python bolt_tpu_torch/analysis/lint.py --concurrency # lock pass only
    python bolt_tpu_torch/analysis/lint.py --codes       # rule table
    python bolt_tpu_torch/analysis/lint.py PATH...       # given paths

Runs with NO torch import (about two seconds over the package): both
lint modules are standard-library only and are loaded straight from
their files, without the package initialisation (which imports torch).

``--check`` also audits every ``# lint: allow(...)`` pragma in the
linted set: a pragma naming an unknown code, or one that no longer
suppresses any finding, fails the gate.
"""

import argparse
import importlib.util
import os
import re
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))

# a well-formed diagnostic code; docstrings DESCRIBING the pragma
# syntax ("allow(BLT1xx <reason>)") parse as pseudo-codes and are not
# audited
_CODE_RE = re.compile(r"^BLT\d{3}$")


def _load(modname, filename):
    """Load a lint module by path under its package name (no ``import
    bolt_tpu_torch``, which would import torch); one instance per
    process, so the merged rule table is shared."""
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        modname, os.path.join(_HERE, filename))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def _modules():
    astlint = _load("bolt_tpu_torch.analysis.astlint", "astlint.py")
    conc = _load("bolt_tpu_torch.analysis.concurrency", "concurrency.py")
    return astlint, conc


def _iter_files(paths, astlint):
    for p in paths:
        if os.path.isdir(p):
            yield from astlint.iter_py_files(p)
        else:
            yield p


def stale_pragmas(paths, passes, astlint):
    """Audit ``lint: allow`` pragmas: re-lint each pragma-bearing file
    with the pragmas disarmed and require every pragma to name a known
    code and to suppress a finding on its line."""
    msgs = []
    for path in _iter_files(paths, astlint):
        with open(path, "r", encoding="utf-8") as fh:
            src = fh.read()
        pragmas = astlint._pragma_lines(src)
        if not pragmas:
            continue
        # disarmed (same line count, so finding lines stay comparable)
        neutered = src.replace("lint: allow(", "lint: off(")
        hits = set()
        for mod in passes:
            try:
                hits.update((f.line, f.code)
                            for f in mod.lint_source(neutered, path))
            except SyntaxError:
                pass
        for line, code in sorted(pragmas.items()):
            if not _CODE_RE.match(code):
                continue
            if code not in astlint.RULES:
                msgs.append("%s:%d: stale pragma: unknown code %r"
                            % (path, line, code))
            elif (line, code) not in hits:
                msgs.append("%s:%d: stale pragma: allow(%s) no longer "
                            "suppresses any finding — remove it"
                            % (path, line, code))
    return msgs


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="AST linter for the bolt_tpu_torch invariants "
                    "(BLT1xx)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "bolt_tpu_torch package)")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero when any finding OR stale pragma "
                         "is reported")
    ap.add_argument("--codes", action="store_true",
                    help="print the merged rule table and exit")
    ap.add_argument("--concurrency", action="store_true",
                    help="run only the lock-hierarchy pass "
                         "(BLT111-BLT114)")
    args = ap.parse_args(argv)

    astlint, conc = _modules()
    if args.codes:
        for code in sorted(astlint.RULES):
            print("%s  %s" % (code, astlint.RULES[code]))
        return 0

    paths = args.paths or [astlint.package_root()]
    passes = (conc,) if args.concurrency else (astlint, conc)
    findings = []
    for mod in passes:
        findings.extend(mod.lint_paths(paths))
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    for f in findings:
        print(f.render())
    n = len(findings)
    print("%d finding(s) over %s" % (n, ", ".join(paths)))
    stale = []
    if args.check:
        stale = stale_pragmas(paths, passes, astlint)
        for msg in stale:
            print(msg)
        if stale:
            print("%d stale pragma(s)" % len(stale))
    return 1 if args.check and (n or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
