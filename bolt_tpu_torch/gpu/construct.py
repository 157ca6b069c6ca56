"""Constructors for the ``mode='gpu'`` backend.

Port of ``bolt_tpu/tpu/construct.py :: ConstructTPU``.  The context that
selects this backend is a ``torch.device`` (the reference's
``jax.sharding.Mesh``).  ``ones``/``zeros``/``full``/``rand``/``randn`` build
their tensor directly on the device, never on the host; ``array`` moves the
key axes to the front and uploads once; ``fromcallback``/``fromiter`` with
a dtype give lazy out-of-core streams (``bolt_tpu_torch/stream.py``).
"""

import numpy as np
import torch

from bolt_tpu_torch.utils import inshape, tupleize


def resolve_device(context):
    """The device of a ``mode='gpu'`` call: ``context`` itself, or
    ``cuda:0`` when it is None.  Raises when CUDA is needed and missing —
    the backend never moves to the CPU on its own; a caller who wants the
    CPU passes ``context=torch.device("cpu")``."""
    if context is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mode='gpu' without a context runs on cuda:0, but CUDA is "
                "not available here; pass context=torch.device('cpu') to "
                "run the gpu backend on the CPU")
        return torch.device("cuda", 0)
    if not isinstance(context, torch.device):
        raise ValueError("context must be a torch.device, got %r"
                         % (context,))
    if context.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("context %s needs CUDA, which is not available "
                           "here" % context)
    return context


class ConstructGPU:
    """Builds :class:`~bolt_tpu_torch.gpu.array.BoltArrayGPU` instances."""

    @staticmethod
    def _argcheck(*args, **kwargs):
        """Claim the construction when a ``torch.device`` appears as a
        positional arg or as ``context=``, or ``mode='gpu'`` is explicit
        (reference: ``ConstructTPU._argcheck`` detects a mesh)."""
        if kwargs.get("mode") == "gpu":
            return True
        if isinstance(kwargs.get("context"), torch.device):
            return True
        return any(isinstance(a, torch.device) for a in args)

    @staticmethod
    def array(a, context=None, axis=(0,), dtype=None, npartitions=None):
        """Place an array-like on the device with ``axis`` as the key axes,
        moved to the front of the logical shape (reference:
        ``ConstructTPU.array``).  A ``torch.Tensor`` or gpu-backend input
        stays on device; ``npartitions`` is accepted for signature
        parity."""
        from bolt_tpu_torch.base import BoltArray
        from bolt_tpu_torch.gpu.array import (BoltArrayGPU, _upload,
                                              torch_dtype)
        device = resolve_device(context)
        axes = sorted(tupleize(axis))
        if len(axes) == 0:
            raise ValueError("at least one key axis is required")
        if isinstance(a, BoltArrayGPU):
            a = a._data
        elif isinstance(a, BoltArray):
            a = a.toarray()
        if isinstance(a, torch.Tensor):
            inshape(tuple(a.shape), axes)
            rest = [i for i in range(a.ndim) if i not in axes]
            data = a.permute(axes + rest).to(
                device, a.dtype if dtype is None else torch_dtype(dtype))
            data = data.contiguous()
            if data.data_ptr() == a.data_ptr():
                data = data.clone()      # never alias the caller's tensor
            return BoltArrayGPU(data, len(axes), device)
        a = np.asarray(a, dtype=dtype)
        inshape(a.shape, axes)
        rest = [i for i in range(a.ndim) if i not in axes]
        return BoltArrayGPU(_upload(np.transpose(a, axes + rest), device),
                            len(axes), device)

    @staticmethod
    def _device_build_spec(shape, context, axis, dtype):
        """``(device, key-axes-first shape, split, torch dtype)`` — the
        prologue shared by the build-on-device constructors."""
        from bolt_tpu_torch.gpu.array import torch_dtype
        device = resolve_device(context)
        shape = tupleize(shape)
        axes = sorted(tupleize(axis))
        if len(axes) == 0:
            raise ValueError("at least one key axis is required")
        inshape(shape, axes)
        rest = [i for i in range(len(shape)) if i not in axes]
        shape = tuple(shape[i] for i in axes + rest)
        if dtype is None:
            dtype = np.float64   # numpy's default
        return device, shape, len(axes), torch_dtype(dtype)

    @staticmethod
    def _filled(fill, shape, context, axis, dtype):
        from bolt_tpu_torch.gpu.array import BoltArrayGPU
        device, shape, split, tdtype = \
            ConstructGPU._device_build_spec(shape, context, axis, dtype)
        if np.ndim(fill):
            # an array-like fill broadcasts against the shape, as jnp.full
            data = torch.as_tensor(np.asarray(fill)).to(device, tdtype)
            data = data.broadcast_to(shape).contiguous()
        else:
            data = torch.full(shape, fill, dtype=tdtype, device=device)
        return BoltArrayGPU(data, split, device)

    @staticmethod
    def _random(kind, shape, context, axis, dtype, seed):
        """Random array generated ON the device from a ``torch.Generator``
        seeded with ``seed`` (any Python int, reduced mod 2**32 like the
        local backend).  Its numbers differ from ``jax.random``'s and from
        numpy's: tests build shared inputs with numpy instead."""
        from bolt_tpu_torch.gpu.array import BoltArrayGPU
        device, shape, split, tdtype = \
            ConstructGPU._device_build_spec(shape, context, axis, dtype)
        if not tdtype.is_floating_point:
            raise ValueError("random constructors require a float dtype, "
                             "got %s" % tdtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % (1 << 32))
        sampler = torch.randn if kind == "randn" else torch.rand
        data = sampler(shape, generator=gen, dtype=tdtype, device=device)
        return BoltArrayGPU(data, split, device)

    @staticmethod
    def randn(shape, context=None, axis=(0,), dtype=None, seed=0):
        """Standard-normal array, generated on the device."""
        return ConstructGPU._random("randn", shape, context, axis, dtype,
                                    seed)

    @staticmethod
    def rand(shape, context=None, axis=(0,), dtype=None, seed=0):
        """Uniform [0, 1) array, generated on the device."""
        return ConstructGPU._random("rand", shape, context, axis, dtype,
                                    seed)

    @staticmethod
    def fromcallback(fn, shape, context=None, axis=(0,), dtype=None,
                     chunks=None, checkpoint=None, codec=None):
        """Build an array by calling ``fn(index)`` per record range, with
        ``index`` a tuple of per-axis slices of the KEY-AXES-FIRST
        ``shape`` (reference: ``ConstructTPU.fromcallback``).

        With an explicit ``dtype`` the result is a LAZY stream
        (``bolt_tpu_torch.stream``): nothing is produced or uploaded until
        a consumer runs; the reduction terminals stream it slab by slab
        (``chunks`` records a slab, default a ``BOLT_STREAM_SLAB_BYTES``
        budget of 64 MiB), any other consumer materialises it.
        ``codec=`` names an ingest codec (``bolt_tpu_torch.gpu.codec``)
        for the streamed runs; ``checkpoint=dir`` makes them resumable
        (``bolt_tpu_torch.stream.resumable``).  ``dtype=None`` keeps whatever the callback
        produces and uploads at once, from one call over the whole
        array."""
        from bolt_tpu_torch.gpu.array import BoltArrayGPU
        explicit = dtype is not None
        device, shape, split, _ = ConstructGPU._device_build_spec(
            shape, context, axis, dtype)
        if explicit:
            from bolt_tpu_torch.stream import StreamSource
            src = StreamSource.from_callback(fn, shape, split, dtype, device,
                                             chunks=chunks,
                                             checkpoint=checkpoint,
                                             codec=codec)
            return BoltArrayGPU._streamed(src)
        from bolt_tpu_torch.stream import transfer
        index = tuple(slice(0, n) for n in shape)
        block = np.asarray(fn(index))
        if block.shape != shape:
            raise ValueError(
                "fromcallback callback returned shape %s for index %s "
                "(expected %s)" % (block.shape, index, shape))
        return BoltArrayGPU(transfer(block, device), split, device)

    @staticmethod
    def fromiter(blocks, shape, context=None, axis=(0,), dtype=None,
                 checkpoint=None, codec=None):
        """A lazy stream over an ITERABLE of consecutive record blocks
        (key-axes-first layout, concatenated along the first key axis;
        together they must cover ``shape``), the sequential twin of
        :meth:`fromcallback` (reference: ``ConstructTPU.fromiter``).
        ``dtype`` is required.  The reduction terminals stream the
        iterator once; other consumers assemble it on the host first."""
        from bolt_tpu_torch.gpu.array import BoltArrayGPU
        from bolt_tpu_torch.stream import StreamSource
        if dtype is None:
            raise ValueError(
                "fromiter requires an explicit dtype (blocks are consumed "
                "lazily, so the element type cannot be inferred up front)")
        device, shape, split, _ = ConstructGPU._device_build_spec(
            shape, context, axis, dtype)
        src = StreamSource.from_iter(blocks, shape, split, dtype, device,
                                     checkpoint=checkpoint, codec=codec)
        return BoltArrayGPU._streamed(src)

    @staticmethod
    def ones(shape, context=None, axis=(0,), dtype=None):
        """Array of ones, built on the device."""
        return ConstructGPU._filled(1, shape, context, axis, dtype)

    @staticmethod
    def zeros(shape, context=None, axis=(0,), dtype=None):
        """Array of zeros, built on the device."""
        return ConstructGPU._filled(0, shape, context, axis, dtype)

    @staticmethod
    def full(shape, value, context=None, axis=(0,), dtype=None):
        """Array filled with ``value``, built on the device; like
        ``numpy.full`` the dtype defaults to the fill value's."""
        if dtype is None:
            dtype = np.asarray(value).dtype
        return ConstructGPU._filled(value, shape, context, axis, dtype)

    @staticmethod
    def concatenate(arrays, axis=0, context=None):
        """Concatenate a sequence of arrays along ``axis`` (reference:
        ``ConstructTPU.concatenate``): gpu-backend operands stay on the
        device and the result keeps the first one's split."""
        if not isinstance(arrays, (tuple, list)) or len(arrays) == 0:
            raise ValueError("concatenate requires a non-empty tuple of "
                             "arrays")
        from bolt_tpu_torch.base import BoltArray
        from bolt_tpu_torch.gpu.array import (BoltArrayGPU, _upload,
                                              numpy_dtype, torch_dtype)
        first = arrays[0]
        if isinstance(first, BoltArrayGPU):
            parts = []
            for a in arrays:
                if isinstance(a, BoltArrayGPU):
                    parts.append(a._data.to(first.device))
                else:
                    parts.append(_upload(
                        a.toarray() if isinstance(a, BoltArray) else a,
                        first.device))
            dtype = torch_dtype(np.result_type(
                *(numpy_dtype(p.dtype) for p in parts)))
            data = torch.cat([p.to(dtype) for p in parts], dim=int(axis))
            return BoltArrayGPU(data, first.split, first.device)
        mats = [a.toarray() if isinstance(a, BoltArray) else np.asarray(a)
                for a in arrays]
        return ConstructGPU.array(np.concatenate(mats, axis), context=context)
