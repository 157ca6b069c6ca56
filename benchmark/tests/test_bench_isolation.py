"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "bolt_tpu", "bolt"}

PROBE = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
harness.run_cell("ns.fused", 3, 0.1, 0, device="cpu",
                 overrides={"config": {"shape": [16, 4, 4, 4]}})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
'''


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_a_run_loads_no_jax():
    import json
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bolt_tpu_torch" in loaded
    assert not loaded & BANNED


def test_no_file_imports_jax():
    files = glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                      recursive=True)
    assert files
    for f in files:
        assert not set(_imports(f)) & BANNED, f


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py"))
    assert len(files) > 5
    for f in files:
        mods = set(_imports(f))
        assert "bolt_tpu_torch" not in mods, f
        assert not mods & BANNED, f


def test_forbidden_names_compare_whole():
    from benchmark import harness
    assert harness.forbidden_modules(["bolt_tpu_torch", "bolt_tpu_torch.ops",
                                      "boltons", "jaxtyping"]) == []
    assert harness.forbidden_modules(["bolt_tpu.ops", "bolt", "jax.numpy",
                                      "flax"]) == ["bolt", "bolt_tpu",
                                                   "flax", "jax"]
