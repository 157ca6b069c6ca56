"""The port stands alone: ``bolt_tpu_torch`` imports neither jax nor the
reference package, and its device entry points never move to the CPU on
their own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import bolt_tpu_torch as bolt
from bolt_tpu_torch import convert
from bolt_tpu_torch.gpu import construct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "bolt_tpu_torch")
MODULES = ["bolt_tpu_torch", "bolt_tpu_torch.ops", "bolt_tpu_torch.ops._build",
           "bolt_tpu_torch.gpu.chunk", "bolt_tpu_torch.gpu.stats",
           "bolt_tpu_torch.convert", "bolt_tpu_torch.statcounter",
           "bolt_tpu_torch.ops.overlap", "bolt_tpu_torch.ops.series",
           "bolt_tpu_torch._precision", "bolt_tpu_torch.precision",
           "bolt_tpu_torch.gpu.dtypes", "bolt_tpu_torch.stream",
           "bolt_tpu_torch.engine", "bolt_tpu_torch.gpu.codec",
           "bolt_tpu_torch.ops.mapexpr", "bolt_tpu_torch.ops.kernels",
           "bolt_tpu_torch.profile", "bolt_tpu_torch.obs",
           "bolt_tpu_torch.obs.trace", "bolt_tpu_torch.obs.metrics",
           "bolt_tpu_torch.obs.export", "bolt_tpu_torch._lockdep",
           "bolt_tpu_torch.gpu.stack", "bolt_tpu_torch.ops.linalg",
           "bolt_tpu_torch.ops.group", "bolt_tpu_torch.ops.hist",
           "bolt_tpu_torch.gpu.npdispatch", "bolt_tpu_torch._chaos",
           "bolt_tpu_torch.checkpoint", "bolt_tpu_torch.parallel.shuffle",
           "bolt_tpu_torch.serve", "bolt_tpu_torch.gpu.batched",
           "bolt_tpu_torch.analysis", "bolt_tpu_torch.analysis.check"]


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_imports_with_jax_blocked():
    code = ("import sys\nsys.modules['jax'] = None\n"
            + "".join("import %s\n" % m for m in MODULES)
            + "assert not any(m == 'bolt_tpu' or m.startswith('bolt_tpu.')"
              " for m in sys.modules), 'reference package imported'\n"
            + "import numpy as np, torch\n"
            + "b = bolt_tpu_torch.ones((4, 3), context=torch.device('cpu'))\n"
            + "assert float(b.map(lambda v: v + 1).sum().toarray().sum())"
              " == 24.0\n"
            + "assert bolt_tpu_torch.ops.mapexpr.compile((lambda v: v * 2,),"
              " (3,), torch.float32) is not None\n"
            + "f = b.map(lambda v: v + 1).filter(lambda v: v.sum() > 0)\n"
            + "assert f.pending and float(f.mean().toarray().sum()) == 6.0\n"
            + "from bolt_tpu_torch.ops import (gaussian, smooth, convolve, "
              "median_filter, map_overlap, sepfilter1d, lane_band, detrend, "
              "zscore)\n"
            + "s = zscore(detrend(gaussian(bolt_tpu_torch.randn((4, 8, 6), "
              "context=torch.device('cpu')), 1.0, axis=(0, 1))), "
              "epsilon=1e-9).stats()\n"
            + "assert s.mean().shape == (8, 6)\n"
            + "x = np.arange(24.0, dtype=np.float32).reshape(6, 4)\n"
            + "with bolt_tpu_torch.stream.uploaders(2):\n"
            + "    t = bolt_tpu_torch.fromcallback(lambda i: x[i], x.shape, "
              "torch.device('cpu'), dtype=np.float32, chunks=2, "
              "codec='delta-f32').sum().toarray()\n"
            + "assert np.array_equal(t, x.sum(0))\n"
            + "s = bolt_tpu_torch.fromcallback(lambda i: x[i], x.shape, "
              "torch.device('cpu'), dtype=np.float32, chunks=2)\n"
            + "assert np.array_equal(s.swap((0,), (0,)).toarray(), x.T)\n"
            + "f = bolt_tpu_torch.fromcallback(lambda i: x[i], x.shape, "
              "torch.device('cpu'), dtype=np.float32, chunks=2).filter("
              "lambda v: v.sum() > 20)\n"
            + "assert f.streaming and np.array_equal(f.sum().toarray(), "
              "x[x.sum(1) > 20].sum(0))\n"
            + "a = bolt_tpu_torch.array(x, torch.device('cpu'))\n"
            + "add1 = lambda v: v + 1\n"
            + "with bolt_tpu_torch.serve.serving(workers=2, batching="
              "{'max_batch': 4, 'linger': 0.01}) as sv:\n"
            + "    fs = [sv.submit(a.map(add1).sum()) for _ in range(4)]\n"
            + "    assert all(np.array_equal(f.result(60).toarray(), "
              "(x + 1).sum(0)) for f in fs)\n"
            + "assert bolt_tpu_torch.analysis.working_set_bytes("
              "a.map(add1)) == 2 * x.nbytes\n"
            + "assert not any(m == 'bolt_tpu' or m.startswith('bolt_tpu.')"
              " for m in sys.modules), 'reference package imported'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "bolt_tpu", "bolt"), \
                "%s imports %s" % (path, name)


def test_gpu_mode_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bolt.ones((4, 3), mode="gpu"),
                 lambda: bolt.randn((4, 3), mode="gpu"),
                 lambda: bolt.array([[1.0, 2.0]], mode="gpu"),
                 lambda: bolt.zeros((4, 3), context=torch.device("cuda")),
                 lambda: bolt.ones((4, 3)).togpu(),
                 lambda: convert.moments_from_reference(0, 0, 0, 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_stream_constructors_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bolt.fromcallback(lambda i: None, (4, 3),
                                           mode="gpu", dtype="float32"),
                 lambda: bolt.fromiter([], (4, 3), mode="gpu",
                                       dtype="float32"),
                 lambda: bolt.fromcallback(lambda i: None, (4, 3),
                                           context=torch.device("cuda"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_gpu_mode_defaults_to_cuda0(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert construct.resolve_device(None) == torch.device("cuda", 0)
    cpu = torch.device("cpu")
    assert construct.resolve_device(cpu) is cpu
    with pytest.raises(ValueError):
        construct.resolve_device("cuda:0")
