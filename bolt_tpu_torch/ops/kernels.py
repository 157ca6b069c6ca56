"""One-pass moment kernels: CUDA on the card, plain PyTorch on the CPU.

Each wrapper checks its tensor and then, for a tensor on a CUDA device,
launches its hand-written kernel from ``csrc/moments.cu`` or raises; only a
tensor that lies on the CPU takes the plain PyTorch version beside it.
The plain versions are also the kernels' oracle on the card.  Each
wrapper counts its launches in ``LAUNCHES``, so a run can show that its
path went through the kernel.

* :func:`fused_welford` replaces ``bolt_tpu/ops/kernels.py ::
  fused_welford`` — column-wise ``(mean, m2, min, max)`` over axis 0 in
  one read of device memory (the body of ``stats()``).
* :func:`fused_stats` replaces ``bolt_tpu/ops/kernels.py :: fused_stats``
  — ``(sum, sum_sq, min, max)`` over every element.

The reference's TPU gates (128-lane minor dimension, the VMEM budgets)
are not carried over: :func:`fused_welford` returns ``None`` only where
the function does not apply (a non-floating dtype, fewer than two
dimensions or fewer than two rows).
"""

import ctypes

import numpy as np
import torch

from bolt_tpu_torch.utils import prod

# launches of each kernel since the last reset (chip_smoke.py zeroes these
# before it drives the main path and reads them after)
LAUNCHES = {"fused_welford": 0, "fused_stats": 0}

# dtype codes of the C entry points (moments.cu)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
_THREADS = 256          # threads per block (moments.cu kThreads)
_MIN_CHUNK_ROWS = 16    # fewest rows a welford row chunk holds
_RESIDENT_THREADS = 2048   # threads one SM holds at once (Hopper)

_SIGNATURES = {
    "bolt_fused_welford": [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "bolt_fused_stats": [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from bolt_tpu_torch.ops import _build
    lib = _build.load("moments.cu")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _acc_dtype(dtype):
    return torch.float32 if dtype in (torch.float16, torch.bfloat16) \
        else dtype


def _vec(x, row):
    """Elements per 16-byte load when ``x`` starts 16-byte aligned and its
    rows of ``row`` elements keep that alignment, else 1."""
    vec = 16 // x.element_size()
    return vec if x.data_ptr() % 16 == 0 and row % vec == 0 else 1


def _check(code, name):
    if code != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, code))


def _on_card(x, name):
    """Validate a tensor headed for a kernel: CUDA device, a type the
    kernel takes, contiguous (``swap``/``transpose`` results are copied,
    never read with the wrong strides)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("%s kernel takes float32/float64/float16/bfloat16, "
                        "got %s" % (name, x.dtype))
    return x.contiguous()


# ---------------------------------------------------------------------------
# fused_welford
# ---------------------------------------------------------------------------

def _fused_welford_plain(x):
    """The plain PyTorch version: two-pass ``m2``, NaN-propagating
    ``amin``/``amax``, accumulated in f32 for f16/bf16, results in
    ``x.dtype``."""
    xa = x.to(_acc_dtype(x.dtype))
    mu = xa.mean(dim=0)
    m2 = ((xa - mu) ** 2).sum(dim=0)
    return tuple(v.to(x.dtype) for v in
                 (mu, m2, torch.amin(xa, dim=0), torch.amax(xa, dim=0)))


def welford_rows(n, columns, vec, sm_count):
    """``(rows per chunk, chunks)`` for :func:`fused_welford` on ``n``
    rows of ``columns`` columns: split the rows only as far as the
    column threads alone leave the card's resident threads idle, and
    never below ``_MIN_CHUNK_ROWS`` rows a chunk."""
    col_threads = -(-columns // vec)
    want = -(-sm_count * _RESIDENT_THREADS // col_threads)
    chunks = max(1, min(want, n // _MIN_CHUNK_ROWS, 65535))
    rpc = -(-n // chunks)
    return rpc, -(-n // rpc)


def fused_welford(x):
    """Single-pass ``(mean, m2, min, max)`` over axis 0 of ``x``, each
    shaped ``x.shape[1:]`` and in ``x.dtype`` (``m2`` = sum of squared
    deviations, the StatCounter field).  ``None`` for a non-floating
    dtype, ``x.ndim < 2`` or ``x.shape[0] < 2``."""
    if not x.is_floating_point() or x.ndim < 2 or x.shape[0] < 2:
        return None
    if x.device.type == "cpu":
        return _fused_welford_plain(x)
    if x.device.type != "cuda":
        raise ValueError("fused_welford runs on CUDA or CPU tensors, got "
                         "device %s" % x.device)
    x = _on_card(x, "fused_welford")
    n, vshape = x.shape[0], tuple(x.shape[1:])
    columns = prod(vshape)
    vec = _vec(x, columns)
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    rpc, chunks = welford_rows(n, columns, vec, sm_count)
    part = torch.empty((chunks, 4, columns), dtype=_acc_dtype(x.dtype),
                       device=x.device)
    outs = [torch.empty(vshape, dtype=x.dtype, device=x.device)
            for _ in range(4)]
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.bolt_fused_welford(
            x.data_ptr(), part.data_ptr(), *(o.data_ptr() for o in outs),
            n, columns, rpc, chunks, _DTYPE_CODE[x.dtype], vec, stream)
    _check(code, "fused_welford")
    LAUNCHES["fused_welford"] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# fused_stats
# ---------------------------------------------------------------------------

def _sum_dtype(dtype):
    """numpy's sum dtype for an integer ``dtype`` (int32 sums in int64)."""
    np_dt = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(np.sum(np.zeros(1, np_dt), keepdims=True)).dtype


def _fused_stats_plain(x):
    """The plain PyTorch version: ``(sum, sum_sq, min, max)`` accumulated
    in f32 for f16/bf16, results in ``x.dtype``."""
    xa = x.to(_acc_dtype(x.dtype))
    return tuple(v.to(x.dtype) for v in
                 (xa.sum(), (xa * xa).sum(), torch.amin(xa), torch.amax(xa)))


def _int_stats(x):
    """Integer inputs, as the reference computes them outside its kernel
    (``jnp.sum``/``jnp.min``/``jnp.max``: sums in numpy's sum dtype)."""
    sdt = _sum_dtype(x.dtype)
    return (x.sum(dtype=sdt), (x * x).sum(dtype=sdt), torch.amin(x),
            torch.amax(x))


def fused_stats(x):
    """One-pass ``(sum, sum_sq, min, max)`` over all elements of ``x``, as
    four 0-d tensors in ``x.dtype`` (integer inputs: sums in numpy's sum
    dtype, computed with torch reductions like the reference does)."""
    if x.numel() == 0:
        raise ValueError("fused_stats of an empty tensor (min/max have no "
                         "identity)")
    if not x.is_floating_point():
        return _int_stats(x)
    if x.device.type == "cpu":
        return _fused_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError("fused_stats runs on CUDA or CPU tensors, got "
                         "device %s" % x.device)
    x = _on_card(x, "fused_stats").reshape(-1)
    vec = _vec(x, 0)      # one row: the kernel folds the ragged tail itself
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(-(-x.numel() // (vec * _THREADS)), 4 * sm_count))
    part = torch.empty((blocks, 4), dtype=_acc_dtype(x.dtype),
                       device=x.device)
    out = torch.empty(4, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.bolt_fused_stats(
            x.data_ptr(), part.data_ptr(), out.data_ptr(), x.numel(),
            blocks, _DTYPE_CODE[x.dtype], vec, stream)
    _check(code, "fused_stats")
    LAUNCHES["fused_stats"] += 1
    return tuple(out[i] for i in range(4))
