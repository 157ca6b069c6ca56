"""The port's repo invariant linters (``bolt_tpu_torch/analysis/
astlint.py``, ``concurrency.py``) and their CLI
(``bolt_tpu_torch/analysis/lint.py``).

The lint halves of ``tests/test_static_analysis.py`` and
``tests/test_concurrency.py`` on the port: zero findings of both passes
on ``bolt_tpu_torch/`` (a tier-1 invariant), a seeded violation for every
rule BLT101–BLT114 (written in torch where the rule names torch), the
exemptions and the pragma escape hatch, the CLI's ``--codes`` and its
``--check`` stale-pragma audit, and the drift gate: the checker's
``CODES`` with the linters' ``RULES`` equal the ``BLT\\d{3}`` codes of
``docs/API.md`` (read, never edited) and the CLI's table.  Exact
comparisons throughout (code lists and sets; no tolerance applies).
"""

import importlib.util
import os
import re
import subprocess
import sys

import pytest

from bolt_tpu_torch.analysis import astlint, diagnostics
from bolt_tpu_torch.analysis import concurrency as conc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(REPO, "bolt_tpu_torch", "analysis", "lint.py")
HERE = "bolt_tpu_torch/ops/foo.py"

pytestmark = pytest.mark.lint


def _codes(src, path=HERE):
    return [f.code for f in astlint.lint_source(src, path)]


def _ccodes(src, path="bolt_tpu_torch/somewhere.py"):
    return [f.code for f in conc.lint_source(src, path)]


def _cli():
    spec = importlib.util.spec_from_file_location("torch_lint_cli", CLI)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# the tier-1 invariant
# ----------------------------------------------------------------------

def test_lint_package_reports_zero_findings():
    found = astlint.lint_package()
    assert found == [], "\n".join(f.render() for f in found)


def test_concurrency_lint_package_zero_findings():
    found = conc.lint_package()
    assert found == [], "\n".join(f.render() for f in found)


def test_blt102_exemptions_are_each_in_use():
    """Every module exempt from BLT102 uses a private torch namespace
    today (an exemption must not outlive its reason)."""
    root = astlint.package_root()
    for suffix in astlint._EXEMPT["BLT102"]:
        path = os.path.join(root, suffix)
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        assert _codes(src, "elsewhere/x.py").count("BLT102") >= 1, suffix


# ----------------------------------------------------------------------
# seeded violations, one (or more) per rule
# ----------------------------------------------------------------------

def test_lint_blt101_compile_outside_the_engine():
    src = "import torch\nfn = torch.compile(lambda x: x + 1)\n"
    assert _codes(src) == ["BLT101"]
    assert _codes("import torch\nm = torch.jit.script(f)\n") == ["BLT101"]
    dec = "import torch\n@torch.jit.script\ndef f(x):\n    return x\n"
    assert _codes(dec) == ["BLT101"]
    # the engine-builder pattern is the sanctioned route
    ok = ("import torch\n"
          "def op(key):\n"
          "    def build():\n"
          "        return torch.compile(lambda x: x * 2)\n"
          "    return _cached_jit(key, build)\n")
    assert _codes(ok) == []
    ok2 = ("import torch\nfrom bolt_tpu_torch import engine\n"
           "fn = engine.get(('k',), lambda: torch.compile(lambda x: x))\n")
    assert _codes(ok2) == []
    # builder names resolve within the sink's enclosing scope only
    cross = ("import torch\n"
             "def a(key):\n"
             "    def build():\n"
             "        return torch.compile(lambda x: x)\n"
             "    return _cached_jit(key, build)\n"
             "def b():\n"
             "    def build():\n"
             "        return torch.compile(lambda x: x)\n"
             "    return build()\n")
    found = astlint.lint_source(cross, HERE)
    assert [x.code for x in found] == ["BLT101"] and found[0].line == 8
    assert _codes(src, "bolt_tpu_torch/engine.py") == []
    pragma = ("import torch\nfn = torch.compile(f)  "
              "# lint: allow(BLT101 documented exception)\n")
    assert _codes(pragma) == []


def test_lint_blt102_private_torch_namespaces():
    assert _codes("import torch\ns = torch._C._cuda_getCurrentRawStream(0)\n"
                  ) == ["BLT102"]
    assert _codes("from torch._subclasses import FakeTensorMode\n") \
        == ["BLT102"]
    assert _codes("import torch._dynamo\n") == ["BLT102"]
    assert _codes("from torch import _prims\n") == ["BLT102"]
    assert _codes("import torch as t\nx = t._refs.add\n") == ["BLT102"]
    # public namespaces and dunders pass
    assert _codes("import torch\nv = torch.__version__\n"
                  "f = torch.func.vmap\n") == []
    # the exempt modules, each for its stated reason
    src = "import torch\ns = torch._C._cuda_getCurrentRawStream(0)\n"
    assert _codes(src, "bolt_tpu_torch/ops/kernels.py") == []
    assert _codes(src, "bolt_tpu_torch/gpu/array.py") == []
    assert _codes(src, "bolt_tpu_torch/gpu/myarray.py") == ["BLT102"]


def test_lint_blt103_precision_switches_and_literals():
    assert _codes("import torch\n"
                  "torch.backends.cuda.matmul.allow_tf32 = True\n") \
        == ["BLT103"]
    assert _codes("import torch\n"
                  "torch.backends.cudnn.allow_tf32 = False\n") == ["BLT103"]
    assert _codes("import torch\n"
                  "torch.set_float32_matmul_precision('high')\n") \
        == ["BLT103"]
    assert _codes("y = einsum('ij,jk', a, b, precision='highest')\n") \
        == ["BLT103"]
    # _precision.py is the one home; resolver calls and defaults pass
    assert _codes("import torch\n"
                  "torch.set_float32_matmul_precision('high')\n",
                  "bolt_tpu_torch/_precision.py") == []
    ok = ("from bolt_tpu_torch._precision import resolve\n"
          "def f(a, b, precision='highest'):\n"
          "    return g(a, b, precision=resolve(precision))\n")
    assert _codes(ok) == []


def test_lint_blt104_concrete_bypass():
    src = "def f(b):\n    return b._concrete.shape\n"
    assert _codes(src) == ["BLT104"]
    assert _codes(src, "bolt_tpu_torch/gpu/array.py") == []
    assert _codes("def f(b):\n    return b._data.shape\n") == []


def test_lint_blt105_non_blocking_upload():
    src = "def f(x, dev):\n    return x.to(dev, non_blocking=True)\n"
    assert _codes(src) == ["BLT105"]
    assert _codes("def f(b, x):\n    b.copy_(x, non_blocking=True)\n") \
        == ["BLT105"]
    assert _codes(src, "bolt_tpu_torch/stream.py") == []
    assert _codes(src, "bolt_tpu_torch/upstream.py") == ["BLT105"]
    # a blocking copy is not a bypass of the ring's fencing
    assert _codes("def f(x, dev):\n    return x.to(dev)\n") == []


def test_lint_blt106_perf_counter_outside_obs():
    src = "import time\nt0 = time.perf_counter()\n"
    assert _codes(src) == ["BLT106"]
    assert _codes("from time import perf_counter as pc\nt = pc()\n") \
        == ["BLT106"]
    assert _codes(src, "bolt_tpu_torch/obs/trace.py") == []
    assert _codes(src, "bolt_tpu_torch/profile.py") == []
    assert _codes(src, "bolt_tpu_torch/jobs/trace.py") == ["BLT106"]


def test_lint_blt107_stray_sync_points():
    assert _codes("import torch\ntorch.cuda.synchronize()\n") == ["BLT107"]
    assert _codes("def f(ev):\n    ev.synchronize()\n") == ["BLT107"]
    assert _codes("import torch\n"
                  "torch.cuda.current_stream().synchronize()\n") \
        == ["BLT107"]
    for home in ("bolt_tpu_torch/stream.py", "bolt_tpu_torch/engine.py",
                 "bolt_tpu_torch/profile.py"):
        assert _codes("import torch\ntorch.cuda.synchronize()\n",
                      home) == []


def test_lint_blt108_thread_construction():
    src = ("import threading\n\n"
           "def f():\n    return threading.Thread(target=print)\n")
    assert _codes(src) == ["BLT108"]
    assert _codes("from concurrent.futures import ThreadPoolExecutor\n"
                  "p = ThreadPoolExecutor(4)\n") == ["BLT108"]
    assert _codes("import threading as t\nx = t.Thread(target=print)\n") \
        == ["BLT108"]
    for home in ("bolt_tpu_torch/stream.py", "bolt_tpu_torch/serve.py"):
        assert _codes(src, home) == []
    assert _codes(src, "bolt_tpu_torch/preserve.py") == ["BLT108"]
    ok = ("import threading\n"
          "E = threading.Event()\nT = threading.local()\n")
    assert _codes(ok) == []


def test_lint_blt109_fault_injection_outside_chaos():
    assert _codes("import os\nos.kill(1, 9)\n") == ["BLT109"]
    assert _codes("import signal\n") == ["BLT109"]
    assert _codes("from signal import SIGKILL\n") == ["BLT109"]
    for home in ("bolt_tpu_torch/_chaos.py", "tests/test_x.py"):
        assert _codes("import os\nos.kill(1, 9)\n", home) == []


def test_lint_blt110_torch_distributed():
    assert _codes("import torch\n"
                  "torch.distributed.init_process_group('gloo')\n") \
        == ["BLT110"]
    assert _codes("import torch.distributed as dist\n") == ["BLT110"]
    assert _codes("from torch import distributed\n") == ["BLT110"]
    assert _codes("from torch.distributed import all_reduce\n") \
        == ["BLT110"]
    assert _codes("import torch.distributed as dist\n",
                  "bolt_tpu_torch/parallel/multihost.py") == []
    assert _codes("import torch.distributed as dist\n",
                  "bolt_tpu_torch/parallel/mymultihost.py") == ["BLT110"]


@pytest.mark.parametrize("module", ["mesh", "sharding", "halo", "harness",
                                    "payloads"])
def test_lint_blt110_fires_beside_multihost(module):
    # the mesh layer's other modules stay wrapper-only: a stray
    # torch.distributed import or call there is a finding
    path = "bolt_tpu_torch/parallel/%s.py" % module
    assert _codes("import torch.distributed as dist\n", path) == ["BLT110"]
    assert _codes("import torch\n"
                  "torch.distributed.all_reduce(torch.ones(1))\n", path) \
        == ["BLT110"]
    assert _codes("from bolt_tpu_torch.parallel import multihost\n"
                  "multihost.barrier('x')\n", path) == []


_PRELUDE = "from bolt_tpu_torch import _lockdep\n"


def test_blt111_raw_lock_construction():
    src = "import threading\nL = threading.Lock()\n"
    assert _ccodes(src) == ["BLT111"]
    assert _ccodes("from threading import Condition\nC = Condition()\n") \
        == ["BLT111"]
    assert _ccodes("import threading as t\nR = t.RLock()\n") == ["BLT111"]
    assert conc.lint_source(src, "bolt_tpu_torch/_lockdep.py") == []
    assert conc.lint_source(src, "tests/test_foo.py") == []
    assert _ccodes(_PRELUDE + "L = _lockdep.lock('no.such.lock')\n") \
        == ["BLT111"]
    assert _ccodes(_PRELUDE + "L = _lockdep.lock(name)\n") == ["BLT111"]
    assert _ccodes(_PRELUDE + "L = _lockdep.rlock('engine.cache')\n") == []
    assert _ccodes(_PRELUDE + "L = _lockdep.lock('analysis.strict')\n") \
        == []
    ok = ("import threading\n"
          "L = threading.Lock()  # lint: allow(BLT111 scratch harness)\n")
    assert _ccodes(ok) == []


def test_blt112_static_rank_inversion():
    decl = (_PRELUDE
            + "OUTER = _lockdep.lock('serve.scheduler')\n"   # rank 34
            + "LEAF = _lockdep.lock('engine.cache')\n")      # rank 54
    bad = decl + ("def f():\n"
                  "    with LEAF:\n"
                  "        with OUTER:\n"
                  "            pass\n")
    found = conc.lint_source(bad, "bolt_tpu_torch/x.py")
    assert [f.code for f in found] == ["BLT112"]
    assert "inverts the declared order" in found[0].message
    good = decl + ("def f():\n"
                   "    with OUTER:\n"
                   "        with LEAF:\n"
                   "            pass\n")
    assert _ccodes(good) == []
    closure = decl + ("def f():\n"
                      "    with LEAF:\n"
                      "        def cb():\n"
                      "            with OUTER:\n"
                      "                pass\n"
                      "        return cb\n")
    assert _ccodes(closure) == []
    attr = (_PRELUDE
            + "class C:\n"
            + "    def __init__(self):\n"
            + "        self.lk = _lockdep.lock('gpu.lru')\n"
            + "        self.st = _lockdep.lock('analysis.strict')\n"
            + "    def f(self):\n"
            + "        with self.lk:\n"
            + "            with self.st:\n"
            + "                pass\n")
    assert _ccodes(attr) == ["BLT112"]


def test_blt113_blocking_call_under_ranked_lock():
    decl = _PRELUDE + "L = _lockdep.lock('engine.cache')\n"
    assert _ccodes(decl + "def f(fut):\n"
                          "    with L:\n"
                          "        fut.result()\n") == ["BLT113"]
    assert _ccodes(decl + "def f(fut):\n"
                          "    with L:\n"
                          "        fut.result(5)\n") == []
    assert _ccodes(decl + "import time\n"
                          "def f():\n"
                          "    with L:\n"
                          "        time.sleep(1)\n") == ["BLT113"]
    assert _ccodes(decl + "def f(ev):\n"
                          "    with L:\n"
                          "        ev.wait()\n") == ["BLT113"]
    assert _ccodes(decl + "import time\n"
                          "def f(fut):\n"
                          "    fut.result()\n"
                          "    time.sleep(1)\n") == []


def test_blt114_raw_program_enqueue_outside_order_lock():
    bad = ("from bolt_tpu_torch import engine\n"
           "def run(key, build, x):\n"
           "    entry = engine.get(key, build)\n"
           "    return entry.fn(x)\n")
    assert _ccodes(bad) == ["BLT114"]
    bound = ("def run(entry, x):\n"
             "    raw = entry.fn\n"
             "    return raw(x)\n")
    assert _ccodes(bound) == ["BLT114"]
    # the dispatch wrapper takes the order lock itself: calling it is
    # the blessed form
    assert _ccodes("from bolt_tpu_torch import engine\n"
                   "def run(key, build, x):\n"
                   "    return engine.get(key, build)(x)\n") == []
    ok = ("from bolt_tpu_torch.engine import order_lock\n"
          "def run(entry, x):\n"
          "    with order_lock():\n"
          "        return entry.fn(x)\n")
    assert _ccodes(ok) == []
    held = (_PRELUDE + "ORDER = _lockdep.rlock('engine.order')\n"
            "class D:\n"
            "    def __call__(self, x):\n"
            "        with ORDER:\n"
            "            return self.fn(x)\n")
    assert _ccodes(held) == []


# ----------------------------------------------------------------------
# the drift gate and the CLI
# ----------------------------------------------------------------------

def test_all_diagnostic_codes_documented_in_api_md():
    with open(os.path.join(REPO, "docs", "API.md"), encoding="utf-8") as fh:
        documented = set(re.findall(r"BLT\d{3}", fh.read()))
    assert set(conc.RULES) <= set(astlint.RULES)
    known = set(diagnostics.CODES) | set(astlint.RULES)
    assert known == documented, (sorted(known - documented),
                                 sorted(documented - known))


def test_lint_codes_table_matches_registry(capsys):
    assert _cli().main(["--codes"]) == 0
    listed = set(re.findall(r"^(BLT\d{3})\b", capsys.readouterr().out,
                            re.M))
    assert listed == set(astlint.RULES)
    assert {"BLT101", "BLT110", "BLT111", "BLT114"} <= listed


def test_stale_pragma_audit_fails_the_check_gate(tmp_path, capsys):
    cli = _cli()
    unknown = tmp_path / "unknown.py"
    unknown.write_text("x = 1  # lint: allow(BLT999 never existed)\n")
    assert cli.main(["--check", str(unknown)]) == 1
    assert "unknown code 'BLT999'" in capsys.readouterr().out
    stale = tmp_path / "stale.py"
    stale.write_text("x = 1  # lint: allow(BLT104 fixed long ago)\n")
    assert cli.main(["--check", str(stale)]) == 1
    assert "no longer suppresses" in capsys.readouterr().out
    live = tmp_path / "live.py"
    live.write_text("import threading\n"
                    "L = threading.Lock()"
                    "  # lint: allow(BLT111 scratch)\n")
    assert cli.main(["--check", str(live)]) == 0


def test_lint_cli_check_mode_passes_and_imports_no_torch(tmp_path):
    probe = ("import runpy, sys\n"
             "sys.argv = ['lint.py', '--check'] + sys.argv[1:]\n"
             "try:\n"
             "    runpy.run_path(%r, run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    code = e.code\n"
             "assert 'torch' not in sys.modules, 'torch imported'\n"
             "assert 'jax' not in sys.modules, 'jax imported'\n"
             "sys.exit(code)\n" % CLI)
    out = subprocess.run([sys.executable, "-c", probe],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nf = torch.compile(lambda x: x)\n")
    out = subprocess.run([sys.executable, "-c", probe, str(bad)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "BLT101" in out.stdout
    out = subprocess.run([sys.executable, CLI, "--concurrency",
                          str(bad)], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "0 finding(s)" in out.stdout
