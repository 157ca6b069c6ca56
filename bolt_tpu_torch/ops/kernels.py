"""Hand-written CUDA kernels on the card, plain PyTorch on the CPU.

Each wrapper checks its tensor and then, for a tensor on a CUDA device,
launches its hand-written kernel from ``csrc/`` or raises; only a tensor
that lies on the CPU takes the plain PyTorch version beside it.  The plain
versions are also the kernels' oracle on the card.  Each wrapper counts
its launches in ``LAUNCHES``, so a run can show that its path went through
the kernel.

* :func:`fused_welford` replaces ``bolt_tpu/ops/kernels.py ::
  fused_welford`` — column-wise ``(mean, m2, min, max)`` over axis 0 in
  one read of device memory (the body of ``stats()``; ``csrc/moments.cu``).
* :func:`fused_stats` replaces ``bolt_tpu/ops/kernels.py :: fused_stats``
  — ``(sum, sum_sq, min, max)`` over every element (``csrc/moments.cu``).
* :func:`sepfilter1d` replaces ``bolt_tpu/ops/kernels.py :: sepfilter1d``
  — a 'same'-size 1-d correlation along any axis with numpy-pad boundary
  modes, in one read and one write (``csrc/window.cu``).
* :func:`lane_band` replaces ``bolt_tpu/ops/kernels.py ::
  lane_band_pallas`` — the same correlation along the last axis in
  constant mode (``csrc/window.cu``; the last-axis kernel also serves
  :func:`sepfilter1d` on the last axis, so it counts as ``lane_band``
  whichever entry point launched it).
* :func:`fused_decode_sum` replaces ``bolt_tpu/ops/kernels.py ::
  fused_decode_sum`` — the int8 codec's decode fused into the streamed
  ``sum`` partial, ``sum(q * scale + zp, axis=0)`` in f32
  (``csrc/codec.cu``).
* :func:`fused_map_reduce` replaces ``bolt_tpu/ops/kernels.py ::
  fused_map_reduce`` — ``sum(fn(x))`` in one read, ``fn`` running inside
  the kernel as an expression program (``ops/mapexpr.py``); and
  :func:`fused_map_reduce_cols`, the same kernel's column form
  ``(n, C) -> (C,)`` with an optional record mask, the body of
  ``map(fn).sum()`` and ``filter(...).sum()`` (``csrc/mapreduce.cu``);
  :func:`fused_map_reduce_lanes` runs either form over the bases of W
  batched serve requests in one launch of up to ``_MAX_LANES`` lanes (the
  batch axis ``jax.vmap`` gives the reference's kernel), their pointers
  in the launch's parameters, counted as ``fused_map_reduce_lanes``.

The reference's TPU gates (128-lane minor dimension, the VMEM budgets,
``_MINOR_MAX_TAPS``, the band's radius of 128) are not carried over: each
wrapper returns ``None`` only where the function does not apply
(:func:`fused_welford`: a non-floating dtype, fewer than two dimensions or
fewer than two rows; the window kernels: a non-floating dtype;
:func:`fused_decode_sum`: not uint8/int8, or fewer than two dimensions).
:func:`fused_map_reduce` keeps the reference's contract instead: an
integer input, or an ``fn`` that does not compile to a program, is summed
by torch.
"""

import contextlib
import ctypes
from collections import namedtuple
from functools import lru_cache

import numpy as np
import torch

from bolt_tpu_torch.ops import mapexpr
from bolt_tpu_torch.utils import prod

# launches of each kernel since the last reset (chip_smoke.py zeroes these
# before it drives a path and reads them after)
LAUNCHES = {"fused_welford": 0, "fused_stats": 0, "sepfilter1d": 0,
            "lane_band": 0, "fused_decode_sum": 0, "fused_map_reduce": 0,
            "fused_map_reduce_lanes": 0}

# dtype codes of the C entry points (moments.cu)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
_THREADS = 256          # threads per block (moments.cu kThreads)
_MIN_CHUNK_ROWS = 16    # fewest rows a welford row chunk holds
_RESIDENT_THREADS = 2048   # threads one SM holds at once (Hopper)

# C entry points of each source and their argument types
_SIGNATURES = {
    "moments.cu": {
        "bolt_fused_welford": [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "bolt_fused_stats": [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p],
    },
    "window.cu": {
        "bolt_window_strided": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "bolt_window_lane": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    },
    "codec.cu": {
        "bolt_fused_decode_sum": [ctypes.c_void_p] * 5 + [
            ctypes.c_int64] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "bolt_fused_decode_sum_rows": [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p],
    },
    "mapreduce.cu": {
        "bolt_fused_map_reduce_cols": [ctypes.c_void_p] * 5 + [
            ctypes.c_int64] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        "bolt_fused_map_reduce_full": [ctypes.c_void_p] * 4 + [
            ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "bolt_fused_map_reduce_cols_lanes": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p],
        "bolt_fused_map_reduce_full_lanes": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "bolt_map_reduce_resident": [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int)],
        "bolt_map_program_bytes": [],
        "bolt_map_lanes_bytes": [],
    },
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@lru_cache(maxsize=None)
def _lib(source="moments.cu"):
    """The library built from ``csrc/<source>``, its entry points' argument
    types set once."""
    from bolt_tpu_torch.ops import _build
    lib = _build.load(source)
    for name, argtypes in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _sm_count(device):
    """Streaming multiprocessors of the CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device):
    """The handle of ``device``'s current CUDA stream, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it, without
    building the stream's Python object (a tenth of the host time)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _on_device(device):
    """A context that makes ``device`` current for a launch, or nothing
    when it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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


def _lanes(columns, vec):
    """Row lanes of a ``_THREADS``-thread block on ``columns`` columns of
    ``vec``-element packs: as many as the columns leave threads idle
    (:func:`welford_rows`'s lanes)."""
    col_threads = -(-columns // vec)
    width = _THREADS
    while width > 1 and width // 2 >= col_threads:
        width //= 2
    return _THREADS // width


def welford_rows(n, columns, vec, sm_count):
    """``(lanes, rows per chunk, chunks)`` for :func:`fused_welford` (and
    :func:`fused_decode_sum`, which shares its plan) on ``n`` rows of
    ``columns`` columns.  A block's ``_THREADS`` threads
    cover ``_THREADS // lanes`` column threads (``vec`` columns each) and
    ``lanes`` row lanes: as many lanes as the columns leave threads idle.
    The rows then split into chunks only as far as the blocks alone leave
    the card's resident threads idle, and never below ``_MIN_CHUNK_ROWS``
    rows a lane."""
    col_threads = -(-columns // vec)
    lanes = _lanes(columns, vec)
    width = _THREADS // lanes
    threads = -(-col_threads // width) * _THREADS
    want = -(-sm_count * _RESIDENT_THREADS // threads)
    chunks = max(1, min(want, n // (_MIN_CHUNK_ROWS * lanes), 65535))
    rpc = -(-n // chunks)
    return lanes, rpc, -(-n // rpc)


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
    lanes, rpc, chunks = welford_rows(n, columns, vec, _sm_count(x.device))
    part = torch.empty((chunks, 4, columns), dtype=_acc_dtype(x.dtype),
                       device=x.device)
    outs = [torch.empty(vshape, dtype=x.dtype, device=x.device)
            for _ in range(4)]
    lib = _lib()
    stream = _stream(x.device)
    with _on_device(x.device):
        code = lib.bolt_fused_welford(
            x.data_ptr(), part.data_ptr(), *(o.data_ptr() for o in outs),
            n, columns, rpc, chunks, lanes, _DTYPE_CODE[x.dtype], vec, stream)
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
    blocks = max(1, min(-(-x.numel() // (vec * _THREADS)),
                        4 * _sm_count(x.device)))
    part = torch.empty((blocks, 4), dtype=_acc_dtype(x.dtype),
                       device=x.device)
    out = torch.empty(4, dtype=x.dtype, device=x.device)
    lib = _lib()
    stream = _stream(x.device)
    with _on_device(x.device):
        code = lib.bolt_fused_stats(
            x.data_ptr(), part.data_ptr(), out.data_ptr(), x.numel(),
            blocks, _DTYPE_CODE[x.dtype], vec, stream)
    _check(code, "fused_stats")
    LAUNCHES["fused_stats"] += 1
    return tuple(out[i] for i in range(4))


# ---------------------------------------------------------------------------
# window kernels: sepfilter1d (any axis) and lane_band (the last axis)
# ---------------------------------------------------------------------------

# boundary-mode codes of the C entry points (window.cu), numpy.pad names
_MODE_CODE = {"constant": 0, "reflect": 1, "edge": 2, "symmetric": 3}


@lru_cache(maxsize=256)
def pad_index(n, left, right, mode):
    """Source index of each position of an axis of length ``n`` padded by
    ``left``/``right`` with numpy.pad boundary ``mode`` — the rule both
    the kernels and their plain versions follow (``jnp.pad`` agrees with
    it, pads wider than the axis included).  Position ``i`` in
    ``[-left, n + right)`` reads:

    * ``constant``: index ``n``, a zero slot the caller appends;
    * ``edge``: ``clamp(i, 0, n - 1)``;
    * ``reflect``: 0 if ``n == 1``, else ``j = |i| mod 2(n-1)`` folded
      back past ``n - 1``;
    * ``symmetric``: ``j = i mod 2n`` folded back past ``n - 1``.
    """
    i = np.arange(-left, n + right, dtype=np.int64)
    inside = (i >= 0) & (i < n)
    if mode == "constant":
        idx = np.where(inside, i, n)
    elif mode == "edge":
        idx = np.clip(i, 0, n - 1)
    elif mode == "reflect":
        if n == 1:
            idx = np.zeros_like(i)
        else:
            p = 2 * (n - 1)
            j = np.abs(i) % p
            idx = np.where(j < n, j, p - j)
    elif mode == "symmetric":
        p = 2 * n
        j = np.mod(i, p)
        idx = np.where(j < n, j, p - 1 - j)
    else:
        raise ValueError("mode must be one of %s, got %r"
                         % (tuple(_MODE_CODE), mode))
    idx.setflags(write=False)
    return idx


def halo_pad(x, ax, left, right, mode):
    """Pad the tensor ``x`` along ``ax`` by ``left``/``right`` with
    numpy.pad boundary ``mode``, through :func:`pad_index` and
    ``index_select`` (``torch.nn.functional.pad`` has no ``symmetric``
    mode and limits ``reflect``'s rank and width).  Runs under
    ``torch.func.vmap``."""
    n = x.shape[ax]
    idx = torch.tensor(pad_index(n, left, right, mode), device=x.device)
    if mode == "constant":
        zero_shape = list(x.shape)
        zero_shape[ax] = 1
        x = torch.cat([x, x.new_zeros(zero_shape)], dim=ax)
    return torch.index_select(x, ax, idx)


def _filter1d(x, ax, taps, mode):
    """Plain correlation of the tensor ``x`` with ``taps`` along ``ax``
    ('same' size, boundary per ``mode``), the arithmetic of the
    reference's ``overlap._filter1d``: ``acc = x[i-r] * t0``, then
    ``acc = acc + x[i-r+k] * tk`` for ``k = 1 .. w-1``, every tap
    multiplied (zero pads and zero taps too), in ``x``'s dtype."""
    w = len(taps)
    n = x.shape[ax]
    xpad = halo_pad(x, ax, w // 2, w - 1 - w // 2, mode)
    acc = None
    for off, t in enumerate(taps):
        piece = xpad.narrow(ax, off, n) * t
        acc = piece if acc is None else acc + piece
    return acc


def _sepfilter1d_plain(x, taps, ax, mode="constant"):
    """The plain PyTorch version of both window kernels: f32/f64 compute
    in their own dtype, f16/bf16 load into f32, accumulate there and
    round once on the store, as the kernels do."""
    acc_dt = _acc_dtype(x.dtype)
    return _filter1d(x.to(acc_dt), ax, taps, mode).to(x.dtype)


def _lane_band_plain(x, taps):
    return _sepfilter1d_plain(x, taps, x.ndim - 1, "constant")


@lru_cache(maxsize=64)
def _taps_on(taps, dtype, device):
    """The taps as a tensor on the card, rounded to the compute dtype once
    on the host (as torch rounds a Python scalar operand)."""
    return torch.tensor(taps, dtype=dtype).to(device)


def _window_args(x, taps, ax, mode):
    """Validate the arguments common to both window entry points; returns
    ``(taps tuple, axis)``."""
    taps = tuple(float(t) for t in taps)
    if not taps:
        raise ValueError("a window needs at least one tap")
    if mode not in _MODE_CODE:
        raise ValueError("mode must be one of %s, got %r"
                         % (tuple(_MODE_CODE), mode))
    if x.ndim == 0:
        raise ValueError("a window runs along an axis; got a 0-d tensor")
    if not -x.ndim <= ax < x.ndim:
        raise ValueError("axis %d out of range for a %d-d tensor"
                         % (ax, x.ndim))
    return taps, ax % x.ndim


def _window(x, taps, ax, mode):
    """Launch the window kernel for axis ``ax`` of the CUDA tensor ``x``:
    the last-axis kernel when ``ax`` is the last axis (counted as
    ``lane_band``), the strided-axis kernel otherwise (``sepfilter1d``)."""
    if x.device.type != "cuda":
        raise ValueError("the window kernels run on CUDA or CPU tensors, "
                         "got device %s" % x.device)
    last = ax == x.ndim - 1
    name = "lane_band" if last else "sepfilter1d"
    x = _on_card(x, name)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    n = x.shape[ax]
    outer = prod(tuple(x.shape[:ax]))
    inner = prod(tuple(x.shape[ax + 1:]))
    t = _taps_on(taps, _acc_dtype(x.dtype), x.device)
    lib = _lib("window.cu")
    stream = _stream(x.device)
    # 16-byte staging loads when the filtered rows keep the alignment
    vec = _vec(x, n if last else inner)
    with _on_device(x.device):
        if last:
            code = lib.bolt_window_lane(
                x.data_ptr(), y.data_ptr(), t.data_ptr(), outer, n,
                len(taps), _MODE_CODE[mode], _DTYPE_CODE[x.dtype], vec,
                stream)
        else:
            code = lib.bolt_window_strided(
                x.data_ptr(), y.data_ptr(), t.data_ptr(), outer, n, inner,
                len(taps), _MODE_CODE[mode], _DTYPE_CODE[x.dtype], vec,
                stream)
    _check(code, name)
    LAUNCHES[name] += 1
    return y


def sepfilter1d(x, taps, ax, mode="constant", precision=None):
    """'same'-size correlation of ``x`` with the 1-d ``taps`` along axis
    ``ax``, boundary per numpy-pad ``mode`` (constant/reflect/edge/
    symmetric), in one read and one write of device memory.  Any rank,
    axis, width (a radius wider than the axis too) and mode; ``None``
    only for a non-floating dtype.  ``precision`` is resolved through
    ``bolt_tpu_torch.precision``: every mode computes the exact f32/f64
    sum (f16/bf16 accumulate in f32), inside each mode's envelope."""
    from bolt_tpu_torch._precision import resolve
    resolve(precision)
    taps, ax = _window_args(x, taps, ax, mode)
    if not x.is_floating_point():
        return None
    if x.device.type == "cpu":
        return _sepfilter1d_plain(x, taps, ax, mode)
    return _window(x, taps, ax, mode)


def lane_band(x, taps, precision=None):
    """The correlation along the LAST axis in constant mode (the reference's
    banded-matmul ``lane_band_pallas``), on the last-axis window kernel:
    any length and any radius.  ``None`` for a non-floating dtype."""
    from bolt_tpu_torch._precision import resolve
    resolve(precision)
    taps, ax = _window_args(x, taps, -1, "constant")
    if not x.is_floating_point():
        return None
    if x.device.type == "cpu":
        return _lane_band_plain(x, taps)
    return _window(x, taps, ax, "constant")


# ---------------------------------------------------------------------------
# fused_decode_sum
# ---------------------------------------------------------------------------

def _fused_decode_sum_plain(q, scale, zp):
    """The plain PyTorch version: decode in f32 (the multiply, then the
    add), then the sum over axis 0."""
    return (q.to(torch.float32) * scale + zp).sum(0)


def _sidecar(v, device):
    """A sidecar scalar (a Python or numpy number, or a one-element tensor)
    as a one-element f32 tensor on ``device``: the tensor itself when it
    already is one (the stream's sidecar is), else a new one."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.float32 and v.device == device and v.numel() == 1:
            return v
        return v.to(device=device, dtype=torch.float32).reshape(1)
    return torch.tensor([float(v)], dtype=torch.float32, device=device)


def _byte_vec(q, columns):
    """Bytes a thread loads a row: the widest of 16, 8 and 4 that the
    start of ``q`` and its row length of ``columns`` bytes keep aligned,
    else 1."""
    for vec in (16, 8, 4):
        if q.data_ptr() % vec == 0 and columns % vec == 0:
            return vec
    return 1


# most rows the short-slab form of fused_decode_sum loads ahead (codec.cu
# kRowsAhead)
_ROWS_AHEAD = 24

DecodePlan = namedtuple("DecodePlan", "kind blocks threads span lanes rpc "
                                      "chunks")


@lru_cache(maxsize=256)
def decode_sum_plan(n, columns, vec, sm_count):
    """The launch plan of :func:`fused_decode_sum` on ``n`` rows of
    ``columns`` bytes, loaded ``vec`` bytes a thread a row, on a card of
    ``sm_count`` SMs.

    * ``kind == "rows"`` (a short, wide slab: 16-byte loads, at most
      ``_ROWS_AHEAD`` rows, and at least a warp's worth of 16-column groups
      for every SM): ``blocks``, a multiple of ``sm_count``, of
      ``threads`` threads (a multiple of 32, at most ``_THREADS``), each
      block summing ``span`` neighbouring groups, so every SM takes the same
      share; each thread loads all its rows before it adds the first.
    * ``kind == "lanes"`` otherwise: ``lanes`` row lanes a block (as
      :func:`welford_rows`), and the rows split into ``chunks`` of ``rpc``
      rows over a grid of ``_THREADS``-thread column blocks: as many chunks
      as the card's resident threads hold in one wave (rounded down, where
      :func:`welford_rows` rounds up), never below ``_MIN_CHUNK_ROWS``
      rows a lane."""
    groups = -(-columns // vec)
    if vec == 16 and n <= _ROWS_AHEAD and groups >= 32 * sm_count:
        per_sm = -(-groups // sm_count)
        blocks = -(-per_sm // _THREADS) * sm_count
        span = -(-groups // blocks)
        return DecodePlan("rows", blocks, -(-span // 32) * 32, span, 1, n, 1)
    lanes = _lanes(columns, vec)
    threads = -(-groups // (_THREADS // lanes)) * _THREADS
    fit = sm_count * _RESIDENT_THREADS // threads
    chunks = max(1, min(fit, n // (_MIN_CHUNK_ROWS * lanes), 65535))
    rpc = -(-n // chunks)
    return DecodePlan("lanes", 0, _THREADS, 0, lanes, rpc, -(-n // rpc))


def fused_decode_sum(q, scale, zp):
    """The int8 codec's decode fused into the sum over axis 0:
    ``sum(q * scale + zp, axis=0)`` in f32, shaped ``q.shape[1:]``, for
    the uint8/int8 wire block ``q`` of shape ``(n, *vshape)`` and its f32
    sidecar ``scale``/``zp`` (numbers or one-element tensors).  ``None``
    when ``q`` is not uint8/int8 or has fewer than two dimensions (the
    caller then keeps the decode route)."""
    if q.dtype not in (torch.uint8, torch.int8) or q.ndim < 2:
        return None
    if q.device.type == "cpu":
        return _fused_decode_sum_plain(q, scale, zp)
    if q.device.type != "cuda":
        raise ValueError("fused_decode_sum runs on CUDA or CPU tensors, got "
                         "device %s" % q.device)
    q = q.contiguous()
    dev = q.device
    n = q.shape[0]
    columns = q.numel() // n if n else prod(tuple(q.shape[1:]))
    out = torch.empty(q.shape[1:], dtype=torch.float32, device=dev)
    if n == 0 or columns == 0:
        return out.zero_()
    s, z = _sidecar(scale, dev), _sidecar(zp, dev)
    vec = _byte_vec(q, columns)
    plan = decode_sum_plan(n, columns, vec, _sm_count(dev))
    lib = _lib("codec.cu")
    signed = int(q.dtype == torch.int8)
    stream = _stream(dev)
    with _on_device(dev):
        if plan.kind == "rows":
            code = lib.bolt_fused_decode_sum_rows(
                q.data_ptr(), out.data_ptr(), s.data_ptr(), z.data_ptr(), n,
                columns, plan.blocks, plan.threads, plan.span, signed,
                stream)
        else:
            part = out if plan.chunks == 1 else torch.empty(
                (plan.chunks, columns), dtype=torch.float32, device=dev)
            code = lib.bolt_fused_decode_sum(
                q.data_ptr(), part.data_ptr(), out.data_ptr(), s.data_ptr(),
                z.data_ptr(), n, columns, plan.rpc, plan.chunks, plan.lanes,
                signed, vec, stream)
    _check(code, "fused_decode_sum")
    LAUNCHES["fused_decode_sum"] += 1
    return out


# ---------------------------------------------------------------------------
# fused_map_reduce
# ---------------------------------------------------------------------------

class _Instr(ctypes.Structure):
    """mapreduce.cu's ``Instr``: ``r[dst] = op(r[a], r[b], k)``."""
    _fields_ = [("op", ctypes.c_int8), ("dst", ctypes.c_int8),
                ("a", ctypes.c_int8), ("b", ctypes.c_int8),
                ("flags", ctypes.c_int32), ("k", ctypes.c_double)]


class _Program(ctypes.Structure):
    """mapreduce.cu's ``Program``, which the C entry points copy into the
    launch's parameters."""
    _fields_ = [("n", ctypes.c_int32), ("flags", ctypes.c_int32),
                ("nfile", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("ins", _Instr * mapexpr.MAX_INSTRUCTIONS)]


# instruction and program flags of mapreduce.cu
_READ_A, _READ_B, _READ_C, _A_PREV, _B_PREV, _C_PREV, _STORE = (
    1, 2, 4, 8, 16, 32, 64)
_STORE_X = 1
_READS_B = frozenset(("ADD", "SUB", "MUL", "DIV", "MAX", "MIN", "GT", "GE",
                      "LT", "LE", "EQ", "NE", "WHERE"))


def _reads(ins):
    """``(flag, previous-result flag, register)`` of each register the
    instruction ``ins`` reads."""
    name = mapexpr.OPS[ins.op]
    out = [] if name == "LOADC" else [(_READ_A, _A_PREV, ins.a)]
    if name in _READS_B:
        out.append((_READ_B, _B_PREV, ins.b))
    if name == "WHERE":
        out.append((_READ_C, _C_PREV, ins.dst))
    return out


def _encode(program):
    """The kernel's encoding of ``program``: each instruction's flags say
    which operands it reads, which of them is the previous instruction's
    result (kept in registers), and whether its result goes to the
    register file in shared memory, which only a read past the next
    instruction needs; ``nfile`` sizes that file."""
    ins = program.instrs
    p = _Program(len(ins), 0, 0, 0)
    stored = set()

    def read_later(reg, i):
        """Whether the value instruction ``i`` writes to ``reg`` (``i ==
        -1``: the element in register 0) is read past the next instruction
        before one overwrites it (the next one reads it forwarded)."""
        for j in range(i + 1, len(ins)):
            if j > i + 1 and any(r == reg for _, _, r in _reads(ins[j])):
                return True
            if ins[j].dst == reg:
                return False
        return False

    if read_later(0, -1):
        p.flags = _STORE_X
        stored.add(0)
    for i, cur in enumerate(ins):
        prev = 0 if i == 0 else ins[i - 1].dst
        flags = 0
        for read, fwd, reg in _reads(cur):
            flags |= read | (fwd if reg == prev else 0)
        if read_later(cur.dst, i):
            flags |= _STORE
            stored.add(cur.dst)
        p.ins[i] = _Instr(cur.op, cur.dst, cur.a, cur.b, flags, cur.const)
    p.nfile = 1 + max(stored) if stored else 0
    return p


def _calls(program):
    """Whether ``program`` calls into the math library (sin, cos, a pow
    of a general exponent): mapreduce.cu then runs its variant that makes
    those calls one value at a time through the register file."""
    return any(mapexpr.OPS[op] in ("SIN", "COS") or (
        mapexpr.OPS[op] == "POWC" and k not in mapexpr.POW_SPECIAL)
        for op, _, _, _, k in program.instrs)


class _Encoded:
    """What the wrapper derives from a program once: its :func:`_encode`
    struct (and that struct's address, which each launch passes), its
    :func:`_calls`, and its launch records by form, shape, device and
    pack width (:func:`_record`)."""

    __slots__ = ("struct", "addr", "calls", "records")

    def __init__(self, program):
        self.struct = _encode(program)
        self.addr = ctypes.addressof(self.struct)
        self.calls = _calls(program)
        self.records = {}


def _encoded(program):
    """The :class:`_Encoded` of ``program``, made on its first launch and
    kept on the program."""
    enc = program.kernel
    if enc is None:
        enc = program.kernel = _Encoded(program)
    return enc


def _program_struct(program):
    """The kernel's encoding of ``program`` (kept on the program)."""
    return _encoded(program).struct


# lanes a launch of fused_map_reduce_lanes takes (mapreduce.cu kMaxLanes):
# the lanes' pointers travel in the launch's parameters, by value
_MAX_LANES = 64


class _Lanes(ctypes.Structure):
    """mapreduce.cu's ``Lanes``: the input base and the output of each lane
    of a launch, copied into the launch's parameters."""
    _fields_ = [("inp", ctypes.c_void_p * _MAX_LANES),
                ("out", ctypes.c_void_p * _MAX_LANES)]


@lru_cache(maxsize=None)
def _mapreduce_lib():
    lib = _lib("mapreduce.cu")
    for name, mirror in (("Program", _Program), ("Lanes", _Lanes)):
        size = getattr(lib, "bolt_map_%s_bytes" % name.lower())()
        if size != ctypes.sizeof(mirror):
            raise RuntimeError("mapreduce.cu's %s is %d bytes, its ctypes "
                               "mirror %d" % (name, size,
                                              ctypes.sizeof(mirror)))
    return lib


# shared memory a block's register file may take at the wide tile: seven
# registers, so two blocks still share an SM's 227 KB; a larger file takes
# the half tile (in f32 at the north-star, a file of eight registers held
# one block an SM at the wide tile and read 22% slower there, files of
# four to seven read 20-25% faster: PERF.md)
_FILE_BYTES = 112 * 1024


def tile_rows(element_size, vec, nregs):
    """Packs of ``vec`` elements (of ``element_size`` bytes) a thread holds
    in one tile of the map-reduce kernel, for a program whose register file
    holds ``nregs`` registers: the wide tile (4 packs; 2 for f16/bf16,
    whose 16-byte packs hold 8 values) while its file fits
    ``_FILE_BYTES``, else half of it; 4 single elements when ``vec`` is
    1.  A wide tile's register takes 16 KB of a block's file in every
    dtype."""
    if vec == 1:
        return 4
    wide = 2 if element_size == 2 else 4
    per_register = 16 * 1024
    return wide if nregs * per_register <= _FILE_BYTES else wide // 2


# the floor of work a map-reduce block takes: packs of one thread (16
# bytes each, or one element where the alignment is lost) before the plan
# adds a block.  It binds only where the input is too small to fill the
# card's resident blocks at that much work each: a (128, 32) f32 base is
# then one block that writes its output (sized on the card with
# tools/mapreduce_probe.py --lanes --floors; PERF.md)
_MIN_PACKS = 8

MapReducePlan = namedtuple("MapReducePlan", "lanes blocks segs direct")


def map_reduce_plan(n, columns, vec, resident):
    """The grid of :func:`fused_map_reduce_cols` on ``n`` rows of
    ``columns`` columns, ``vec`` elements a pack, when the card holds
    ``resident`` blocks of the kernel at once.  The ``lanes``-lane blocks
    cover ``G`` column blocks of ``_THREADS // lanes * vec`` columns, and
    the ``W = G * n`` row units split into ``blocks = min(resident, W)``
    equal shares, one a block: one wave, so no SM waits on a second one.
    A small input takes fewer blocks: each gets at least ``lanes *
    _MIN_PACKS`` units (``_MIN_PACKS`` packs a thread) but never fewer
    than ``G`` blocks, which each hold one column block whole; the floor
    binds only where ``W < lanes * _MIN_PACKS * resident``.  ``segs``
    bounds the column blocks one share touches (the scratch holds ``blocks
    * segs`` partial rows); ``direct`` when every block holds one column
    block whole (``blocks == G``), so the kernel writes the output and no
    partials are combined."""
    lanes = _lanes(columns, vec)
    groups = -(-columns // (_THREADS // lanes * vec))
    units = groups * n
    floor = -(-units // (lanes * _MIN_PACKS))
    blocks = max(1, min(resident, units, max(groups, floor)))
    if blocks == groups:
        return MapReducePlan(lanes, blocks, 1, True)
    segs = (-(-units // blocks) - 1) // n + 2
    return MapReducePlan(lanes, blocks, segs, False)


def _full_plan(numel, vec, resident):
    """The grid of :func:`fused_map_reduce_program` on ``numel`` elements,
    ``vec`` a pack: one wave of at most ``resident`` blocks, each thread
    taking at least ``_MIN_PACKS`` packs, so a small input is one block,
    which writes the output with no scratch and no fold kernel."""
    units = -(-numel // (vec * _THREADS))
    return max(1, min(resident, -(-units // _MIN_PACKS)))


def lane_launches(vecs, capacity=_MAX_LANES):
    """How :func:`fused_map_reduce_lanes` splits a batch whose lanes load
    ``vecs[i]`` elements a pack: ``[(vec, [lane, ...]), ...]``, the lanes
    of one pack width together (in the order the widths first appear,
    each in lane order), at most ``capacity`` lanes a launch."""
    groups = {}
    for i, vec in enumerate(vecs):
        groups.setdefault(vec, []).append(i)
    return [(vec, idx[k:k + capacity]) for vec, idx in groups.items()
            for k in range(0, len(idx), capacity)]


@lru_cache(maxsize=None)
def _resident(device, form, lanes, dtype, vec, rows, calls, nfile):
    """Blocks of the map-reduce variant that ``device`` holds at once,
    over all its SMs (the occupancy API, asked once a variant)."""
    per_sm = ctypes.c_int(0)
    with _on_device(device):
        code = _mapreduce_lib().bolt_map_reduce_resident(
            form, lanes, _DTYPE_CODE[dtype], vec, rows, int(calls), nfile,
            ctypes.byref(per_sm))
    _check(code, "fused_map_reduce")
    return per_sm.value * _sm_count(device)


def _fused_map_reduce_plain(x, program, mask=None, cols=False):
    """The plain PyTorch version: :func:`mapexpr.evaluate`, then the sum
    over every element (``cols``: over axis 0, skipping the rows whose
    ``mask`` is false) in the accumulator dtype, cast to ``x.dtype``."""
    y = mapexpr.evaluate(program, x).to(_acc_dtype(x.dtype))
    if not cols:
        return y.sum().to(x.dtype)
    if mask is not None:
        keep = mask.to(torch.bool).reshape((-1,) + (1,) * (y.ndim - 1))
        y = torch.where(keep, y, torch.zeros((), dtype=y.dtype,
                                             device=y.device))
    return y.sum(0).to(x.dtype)


def _check_program(x, program):
    if program.dtype != x.dtype:
        raise TypeError("program compiled for %s, got a %s tensor"
                        % (program.dtype, x.dtype))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("fused_map_reduce runs on CUDA or CPU tensors, got "
                         "device %s" % x.device)


def fused_map_reduce_cols(x, program, mask=None):
    """The column form of :func:`fused_map_reduce`: ``sum(fn(x), axis=0)``
    of the 2-d tensor ``x`` ``(n, C)`` as a ``(C,)`` tensor of ``x.dtype``
    (accumulated in f32 for f16/bf16), ``fn`` given as the
    :class:`mapexpr.Program` ``program``.  ``mask``, a bool or uint8
    ``(n,)`` tensor, drops the rows where it is false: they are not read,
    so a dropped row of NaN leaves the sum finite."""
    _check_program(x, program)
    if x.ndim != 2:
        raise ValueError("fused_map_reduce_cols takes a 2-d tensor, got "
                         "shape %s" % (tuple(x.shape),))
    n, columns = x.shape
    if mask is not None and (tuple(mask.shape) != (n,)
                             or mask.dtype not in (torch.bool, torch.uint8)
                             or mask.device != x.device):
        raise ValueError("the mask must be a bool or uint8 (%d,) tensor on "
                         "%s" % (n, x.device))
    if x.device.type == "cpu":
        return _fused_map_reduce_plain(x, program, mask, cols=True)
    x = _on_card(x, "fused_map_reduce")
    out = torch.empty(columns, dtype=x.dtype, device=x.device)
    if n == 0 or columns == 0:
        return out.zero_()
    m = None if mask is None else mask.contiguous().view(torch.uint8)
    enc = _encoded(program)
    rec = _record(enc, True, (n, columns), x.dtype, x.device,
                  _vec(x, columns))
    part = None if not rec.part else torch.empty(
        rec.part, dtype=_acc_dtype(x.dtype), device=x.device)
    with _on_device(x.device):
        code = _mapreduce_lib().bolt_fused_map_reduce_cols(
            enc.addr, x.data_ptr(), None if m is None else m.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            *rec.args, _stream(x.device))
    _check(code, "fused_map_reduce")
    LAUNCHES["fused_map_reduce"] += 1
    return out


def fused_map_reduce_program(x, program):
    """``sum(fn(x))`` over every element of ``x`` as a 0-d tensor of
    ``x.dtype`` (accumulated in f32 for f16/bf16), ``fn`` given as the
    :class:`mapexpr.Program` ``program``: the full form of the kernel."""
    _check_program(x, program)
    if x.device.type == "cpu":
        return _fused_map_reduce_plain(x, program)
    x = _on_card(x, "fused_map_reduce")
    out = torch.empty((), dtype=x.dtype, device=x.device)
    numel = x.numel()
    if numel == 0:
        return out.zero_()
    enc = _encoded(program)
    # one row: the kernel folds the ragged tail itself
    rec = _record(enc, False, numel, x.dtype, x.device, _vec(x, 0))
    part = None if not rec.part else torch.empty(
        rec.part, dtype=_acc_dtype(x.dtype), device=x.device)
    with _on_device(x.device):
        code = _mapreduce_lib().bolt_fused_map_reduce_full(
            enc.addr, x.data_ptr(), None if part is None else part.data_ptr(),
            out.data_ptr(), *rec.args, _stream(x.device))
    _check(code, "fused_map_reduce")
    LAUNCHES["fused_map_reduce"] += 1
    return out


# a launch of the map-reduce kernel planned once: ``args``, the C entry
# points' arguments from the shape on (the plan, the dtype code and the
# variant); ``part``, the scratch elements a lane takes (0: none, the
# kernel writes its output); ``kernels``, the kernels a launch runs (2
# where a combine or fold kernel adds the partials)
_Launch = namedtuple("_Launch", "args part kernels")
_RECORDS_MAX = 64       # launch records kept a program


def _record(enc, cols, dims, dtype, device, vec):
    """The :data:`_Launch` of the program ``enc`` on a contiguous base of
    ``dtype`` on the CUDA ``device``, loading ``vec`` elements a pack:
    the column form on ``dims = (n, C)`` or the full form on ``dims``
    elements.  Planned on first use (the tile, the occupancy API's
    resident blocks, the grid) and kept on the program, so a launch only
    fills in its pointers."""
    key = (cols, dims, device, vec)
    rec = enc.records.get(key)
    if rec is not None:
        return rec
    struct, calls = enc.struct, enc.calls
    rows = tile_rows(dtype.itemsize, vec, struct.nfile + calls)
    code = _DTYPE_CODE[dtype]
    if cols:
        n, columns = dims
        lanes = _lanes(columns, vec)
        plan = map_reduce_plan(n, columns, vec, _resident(
            device, 0, lanes, dtype, vec, rows, calls, struct.nfile))
        part = 0 if plan.direct else \
            plan.blocks * plan.segs * (_THREADS // lanes) * vec
        rec = _Launch((n, columns, lanes, plan.blocks, plan.segs, code, vec,
                       rows), part, 1 if plan.direct else 2)
    else:
        blocks = _full_plan(dims, vec, _resident(
            device, 1, 1, dtype, vec, rows, calls, struct.nfile))
        part = 0 if blocks == 1 else blocks
        rec = _Launch((dims, blocks, code, vec, rows), part,
                      1 if blocks == 1 else 2)
    if len(enc.records) >= _RECORDS_MAX:
        enc.records.clear()
    enc.records[key] = rec
    return rec


def _fused_map_reduce_lanes_plain(xs, program, cols=False):
    """The plain PyTorch version of :func:`fused_map_reduce_lanes`: the
    plain version of one lane, for each lane, stacked."""
    return torch.stack([_fused_map_reduce_plain(x, program, cols=cols)
                        for x in xs])


def fused_map_reduce_lanes(xs, program, cols=False):
    """:func:`fused_map_reduce_program` (``cols=False``) or
    :func:`fused_map_reduce_cols` (``cols=True``, no mask) of each tensor
    of ``xs``, W tensors of one shape, dtype and device, as one stacked
    ``(W,)`` or ``(W, C)`` tensor: the serving layer's batched ``sum``
    (``gpu/batched.py``).  Each lane gets the standalone plan of its own
    base (pack width, tile, grid and scratch), so lane ``i`` equals the
    standalone launch on ``xs[i]`` bit for bit; the lanes of one pack
    width (a base's 16-byte alignment decides it) share a launch, up to
    ``_MAX_LANES`` a launch (:func:`lane_launches`), whose grid's second
    axis is the lane, reading each base in place through the pointers
    the launch's parameters carry (no table is copied to the device).
    The plan comes from the program's launch record, made once a shape."""
    xs = list(xs)
    if not xs:
        raise ValueError("fused_map_reduce_lanes needs at least one lane")
    x0 = xs[0]
    _check_program(x0, program)
    shape, dtype, device = x0.shape, x0.dtype, x0.device
    for x in xs:
        if x.shape != shape or x.dtype != dtype or x.device != device:
            raise ValueError("fused_map_reduce_lanes takes lanes of one "
                             "shape, dtype and device; got %s %s on %s "
                             "beside %s %s on %s"
                             % (tuple(x.shape), x.dtype, x.device,
                                tuple(shape), dtype, device))
    if cols and len(shape) != 2:
        raise ValueError("the column form takes 2-d lanes, got shape %s"
                         % (tuple(shape),))
    if device.type == "cpu":
        return _fused_map_reduce_lanes_plain(xs, program, cols)
    if dtype not in _DTYPE_CODE:
        _on_card(x0, "fused_map_reduce")        # raises the TypeError
    out = torch.empty((len(xs),) + ((shape[1],) if cols else ()),
                      dtype=dtype, device=device)
    numel = x0.numel()
    if numel == 0:
        return out.zero_()
    xs = [x if x.is_contiguous() else x.contiguous() for x in xs]
    ptrs = [x.data_ptr() for x in xs]
    width = 16 // x0.element_size()
    row = shape[1] if cols else 0
    vecs = [width if p % 16 == 0 and row % width == 0 else 1 for p in ptrs]
    o, step = out.data_ptr(), (shape[1] if cols else 1) * x0.element_size()
    enc = _encoded(program)
    lib = _mapreduce_lib()
    entry = lib.bolt_fused_map_reduce_cols_lanes if cols else \
        lib.bolt_fused_map_reduce_full_lanes
    dims = tuple(shape) if cols else numel
    stream = _stream(device)
    for vec, idx in lane_launches(vecs):
        rec = _record(enc, cols, dims, dtype, device, vec)
        table = _Lanes()
        k = len(idx)
        table.inp[:k] = [ptrs[i] for i in idx]
        table.out[:k] = [o + i * step for i in idx]
        part = None if not rec.part else torch.empty(
            k * rec.part, dtype=_acc_dtype(dtype), device=device)
        with _on_device(device):
            code = entry(enc.addr, ctypes.byref(table), k,
                         None if part is None else part.data_ptr(),
                         *rec.args, stream)
        _check(code, "fused_map_reduce_lanes")
        LAUNCHES["fused_map_reduce_lanes"] += 1
    return out


def fused_map_reduce(x, fn=None):
    """``sum(fn(x))`` over every element of the tensor ``x`` in one read
    (``fn``: an elementwise callable, the identity when ``None``), as a
    0-d tensor of ``x.dtype``, accumulated in f32 for f16/bf16.  ``fn``
    runs inside the kernel when it compiles to an expression program
    (:func:`mapexpr.compile`: a pointwise chain of the opcode table); an
    integer ``x``, or an ``fn`` that does not compile, is summed by torch
    in jnp's sum dtype, as the reference's own fallback branch does."""
    program = mapexpr.compile(() if fn is None else (fn,), tuple(x.shape),
                              x.dtype)
    if program is None:
        y = x if fn is None else fn(x)
        sdt = _sum_dtype(y.dtype) if not y.is_floating_point() else y.dtype
        # torch has no uint64 sum: int64 wraps modulo 2**64 alike
        acc = torch.int64 if sdt == torch.uint64 else sdt
        return torch.sum(y, dtype=acc).to(sdt)
    return fused_map_reduce_program(x, program)
