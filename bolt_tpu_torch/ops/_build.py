"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, into ``build/bolt_tpu_torch/`` at the root of the checkout (a
directory ``.gitignore`` lists), and loaded with ``ctypes``.  The library
name carries a digest of the source and the flags, so an edited source
builds anew and a stale library is never loaded.  A failed build raises
with the compiler's output; nothing falls back to a plain path.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "bolt_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED = {}      # source name -> ctypes.CDLL
BUILD_LOG = {}    # source name -> the compiler's output (ptxas register use)


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): "
            "the bolt_tpu_torch CUDA kernels are built at first use on a "
            "machine with the CUDA toolkit")
    return path


def _target(name):
    with open(os.path.join(CSRC, name), "rb") as f:
        digest = hashlib.sha1(f.read() + repr(NVCC_FLAGS).encode())
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (stem,
                                                    digest.hexdigest()[:12]))


def sources():
    """The CUDA sources of the port, by file name."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def build(names=None):
    """Compile the named sources (default: all), one ``nvcc`` process per
    source, all started together; returns ``{name: library path}``.
    Sources whose library already exists are not rebuilt."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
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
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(name):
    """The ``ctypes`` library built from ``csrc/<name>``, building it on
    first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _LOADED[name] = lib
        return lib
