"""bolt_tpu_torch — the bolt n-dimensional array on PyTorch and CUDA.

A port of ``bolt_tpu`` (JAX on a TPU) to one NVIDIA H100.  One API over
two backends:

* ``mode='local'`` — NumPy, the semantic oracle;
* ``mode='gpu'``  — a ``torch.Tensor`` on a ``torch.device`` (``cuda:0``
  when no context is given), with ``map`` batched by ``torch.func.vmap``,
  statistics on hand-written CUDA kernels (``bolt_tpu_torch.ops``),
  ``swap`` as a permute, and ``fromcallback``/``fromiter`` streams that
  reduce arrays larger than device memory (``bolt_tpu_torch.stream``).

Every terminal builds its program once through the dispatch engine
(``bolt_tpu_torch.engine``: the program cache, its counters, donation
and the dispatch order); ``bolt_tpu_torch.profile`` times and
instruments it and ``bolt_tpu_torch.obs`` traces it.

>>> import torch, bolt_tpu_torch as bolt
>>> b = bolt.ones((8, 100, 50), context=torch.device("cuda"))
>>> b.map(lambda x: x + 1).sum().toarray()

This package imports torch and numpy only: never jax, never ``bolt_tpu``.
"""

__version__ = "0.1.0"

from bolt_tpu_torch._precision import accumulate, precision
from bolt_tpu_torch.base import BoltArray, HostFallbackWarning
from bolt_tpu_torch.factory import (array, concatenate, fromcallback,
                                    fromiter, full, ones, rand, randn, zeros)
from bolt_tpu_torch.gpu.array import BoltArrayGPU
from bolt_tpu_torch.gpu.multistat import compute
from bolt_tpu_torch.local.array import BoltArrayLocal
from bolt_tpu_torch.utils import allclose
from bolt_tpu_torch import engine, obs, profile, stream  # noqa: E402

__all__ = ["array", "ones", "zeros", "full", "rand", "randn",
           "concatenate", "fromcallback", "fromiter", "stream", "engine",
           "profile", "obs", "allclose", "precision", "accumulate",
           "compute", "BoltArray", "BoltArrayLocal", "BoltArrayGPU",
           "HostFallbackWarning", "__version__"]
