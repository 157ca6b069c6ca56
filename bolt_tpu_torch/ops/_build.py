"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, into ``build/bolt_tpu_torch/`` at the root of the checkout (a
directory ``.gitignore`` lists; ``engine.persistent_cache(dir)`` points
it elsewhere), and loaded with ``ctypes``.  The library
name carries a digest of the source and the flags, so an edited source
builds anew and a stale library is never loaded.  A failed build raises
with the compiler's output; nothing falls back to a plain path.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

from bolt_tpu_torch import _lockdep
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.obs.trace import clock as _clock

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
DEFAULT_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "bolt_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = _lockdep.lock("ops.build")
_LOADED = {}      # source name -> ctypes.CDLL
BUILD_DIR = DEFAULT_BUILD_DIR   # the build directory in use
BUILD_LOG = {}    # source name -> the compiler's output (ptxas register use)


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): "
            "the bolt_tpu_torch CUDA kernels are built at first use on a "
            "machine with the CUDA toolkit")
    return path


def build_dir():
    """The directory the libraries are built into and loaded from."""
    return BUILD_DIR


def set_build_dir(path):
    """Build into and load from ``path`` (``None``: the default)."""
    global BUILD_DIR
    BUILD_DIR = DEFAULT_BUILD_DIR if path is None else os.path.abspath(path)


def _target(name):
    with open(os.path.join(CSRC, name), "rb") as f:
        digest = hashlib.sha1(f.read() + repr(NVCC_FLAGS).encode())
    stem = os.path.splitext(name)[0]
    return os.path.join(build_dir(), "lib%s-%s.so" % (stem,
                                                    digest.hexdigest()[:12]))


def sources():
    """The CUDA sources of the port, by file name."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def build(names=None):
    """Compile the named sources (default: all), one ``nvcc`` process per
    source, all started together; returns ``{name: library path}``.
    Sources whose library already exists are not rebuilt.  Each real
    build counts as a ``persistent_misses`` of the engine, and its wall
    time as ``compile_seconds``."""
    from bolt_tpu_torch import engine
    names = sources() if names is None else list(names)
    os.makedirs(build_dir(), exist_ok=True)
    out, procs = {}, {}
    for name in names:
        target = _target(name)
        out[name] = target
        if os.path.exists(target):
            continue
        # each build writes its own temporary file and renames it into
        # place, so concurrent builders never load a half-written library
        tmp = "%s.%d.tmp" % (target, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    sp = _obs.begin("engine.compile") if procs else None
    t0 = _clock()
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
            continue
        os.replace(tmp, target)
    _obs.end(sp)
    for name in procs:
        if name in out and os.path.exists(out[name]):
            engine.record_library(True, (_clock() - t0) / len(procs))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(name):
    """The ``ctypes`` library built from ``csrc/<name>``, building it on
    first use (a library found already built counts as a
    ``persistent_hits`` of the engine)."""
    from bolt_tpu_torch import engine
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            built = os.path.exists(_target(name))
            lib = ctypes.CDLL(build([name])[name])
            _LOADED[name] = lib
            if built:
                engine.record_library(False)
        return lib


def load_built():
    """Load every library already built in the build directory (no
    ``nvcc``); returns the names loaded."""
    with _LOCK:
        names = [n for n in sources() if os.path.exists(_target(n))]
        for n in names:
            _LOADED.pop(n, None)
    for n in names:
        load(n)
    return names
