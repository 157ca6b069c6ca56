"""Codec-encoded streaming ingest: move fewer bytes over the link.

Port of ``bolt_tpu/tpu/codec.py``.  The streaming executor
(``bolt_tpu_torch.stream``) consults this registry: uploader workers
ENCODE each slab on the host (counted as ``codec_encode_seconds`` /
``codec_bytes_raw`` / ``codec_bytes_wire``), the wire block plus a small
sidecar crosses the link, and the slab program DECODES it on the slab's
device before the stages and the terminal partial run.

========== ========= ======= ====================================
name       wire      ratio*  contract
========== ========= ======= ====================================
``bf16``   bfloat16  0.5     lossy down-cast; ~1e-2 relative
                             (:func:`bolt_tpu_torch._precision.codec_bound`)
``f16``    float16   0.5     lossy down-cast; ~1e-3 relative
``int8``   uint8 +   0.25    lossy per-slab affine quantisation,
           sidecar           ``q = round((x - zp) / scale)``; the f32
                             ``(scale, zp)`` pair rides as a sidecar;
                             worst case ~scale/2 absolute an element
                             (finite values only)
``delta-`` int32     1.0     LOSSLESS: f32 bits delta-coded along the
``f32``    (bits of          trailing value axis (wraparound), decoded
           uint32)           by an exact cumsum: bit-identical
``dict``   uint8 +   --      LOSSLESS dictionary coding of integer/bool
           sidecar           slabs with at most 256 distinct values
========== ========= ======= ====================================

\\* wire bytes / raw bytes for a float32 source.

The wire and sidecar bits equal the reference's: int8, delta-f32 and dict
keep its numpy encoders, f16 casts with numpy as it does, and bf16 casts
with torch on the host (round to nearest even, as ``ml_dtypes`` does; a
NaN's bits may differ, see ROADMAP C).  The delta wire travels as int32,
the same bits as the reference's uint32: torch has no uint32 cumsum, so
decode sums in int64 and folds the sum back to 32 bits.

Order statistics and integer/bool pipelines refuse lossy codecs (the
executor and :meth:`Codec.wire_dtype` raise).  ``BOLT_CODEC_KERNEL=1`` arms
the hand-written decode-and-reduce kernel
(``bolt_tpu_torch.ops.kernels.fused_decode_sum``) for a streamed int8
``sum`` with no stages (:func:`kernel_enabled`).
"""

import os

import numpy as np
import torch

from bolt_tpu_torch._precision import codec_bound  # noqa: F401  (re-export)


class Codec:
    """One wire codec: host-side :meth:`encode` (runs on the uploader
    workers) and device-side :meth:`decode` (torch on the slab's device).

    The wire block keeps the raw block's shape; only the dtype changes.
    ``sidecar`` says whether :meth:`encode` returns per-slab side arrays
    that must ride along to :meth:`decode`."""

    name = None
    lossless = False
    sidecar = False

    def wire_dtype(self, dtype):
        """The torch wire dtype for the numpy source ``dtype``; raises a
        pointed ``ValueError`` when this codec cannot encode it."""
        raise NotImplementedError

    def ratio(self, dtype):
        """wire bytes / raw bytes for ``dtype`` (sidecar excluded)."""
        dtype = np.dtype(dtype)
        return self.wire_dtype(dtype).itemsize / float(dtype.itemsize)

    def encode(self, block, delta_ok=True):
        """``(wire, sidecar_tuple)`` for one host slab: ``wire`` a CPU
        tensor, the sidecars numpy values.  ``delta_ok`` is False when the
        block has no trailing value axis (only the delta codec reads
        it)."""
        raise NotImplementedError

    def decode(self, wire, sidecar, dtype, delta_ok=True):
        """Decoded values of the torch ``dtype`` with the wire's shape, on
        the wire's device; ``sidecar`` holds tensors on that device."""
        raise NotImplementedError

    def _refuse(self, dtype, why):
        raise ValueError(
            "codec %r cannot encode a %s pipeline: %s.  Stream "
            "uncompressed, or pick a codec from %r that supports the "
            "dtype" % (self.name, np.dtype(dtype), why, names()))


class _CastCodec(Codec):
    """Down-cast codecs (``bf16``/``f16``): the wire is the raw block cast
    to a half-width float; decode casts back."""

    def __init__(self, name, wire, cast):
        self.name = name
        self._wire = wire
        self._cast = cast

    def wire_dtype(self, dtype):
        dtype = np.dtype(dtype)
        if not np.issubdtype(dtype, np.floating) \
                or dtype.itemsize <= self._wire.itemsize:
            self._refuse(dtype, "the down-cast needs a wider float "
                                "source (float32/float64)")
        return self._wire

    def encode(self, block, delta_ok=True):
        block = np.asarray(block)
        self.wire_dtype(block.dtype)
        return self._cast(block), ()

    def decode(self, wire, sidecar, dtype, delta_ok=True):
        return wire.to(dtype)


def _cast_bf16(block):
    """The reference's bf16 wire bits (its ml_dtypes cast): an f64 block
    rounds to f32 first; every non-NaN value rounds to nearest even (torch's
    cast, on the f32 bits); a NaN becomes ``sign | 0x7FC0``, payload and
    signalling bit aside, where torch's cast gives ``0xFFFF``."""
    with np.errstate(over="ignore"):     # a finite f64 beyond f32's range
        f32 = np.ascontiguousarray(block, dtype=np.float32)
    out = torch.from_numpy(f32).to(torch.bfloat16)
    nan = np.isnan(f32)
    if nan.any():
        sign = (f32.view(np.uint32)[nan] >> 16).astype(np.uint16) & 0x8000
        out.view(torch.int16).numpy()[nan] = (sign | 0x7FC0).view(np.int16)
    return out


def _cast_f16(block):
    # numpy rounds f64 straight to f16; torch would round twice (via f32)
    return torch.from_numpy(np.ascontiguousarray(block.astype(np.float16)))


class _Int8Codec(Codec):
    """Per-slab affine quantisation into uint8 with the f32 ``(scale, zp)``
    pair as a sidecar; decode is ``q * scale + zp``.  Lossy (worst case
    ~``scale / 2`` absolute an element, ``scale`` = the slab's range /
    255) and defined for finite float values only."""

    name = "int8"
    sidecar = True

    def wire_dtype(self, dtype):
        dtype = np.dtype(dtype)
        if not np.issubdtype(dtype, np.floating):
            self._refuse(dtype, "affine quantisation is defined for "
                                "float sources only")
        return torch.uint8

    def encode(self, block, delta_ok=True):
        block = np.asarray(block)
        self.wire_dtype(block.dtype)
        lo = float(block.min()) if block.size else 0.0
        hi = float(block.max()) if block.size else 0.0
        scale = (hi - lo) / 255.0
        if scale <= 0.0 or not np.isfinite(scale):
            scale = 1.0                     # constant slab: q == 0
        q = np.clip(np.rint((block - lo) / scale), 0, 255).astype(
            np.uint8)
        return torch.from_numpy(q), (np.float32(scale), np.float32(lo))

    def decode(self, wire, sidecar, dtype, delta_ok=True):
        scale, zp = sidecar
        return (wire.to(torch.float32) * scale + zp).to(dtype)


class _DictCodec(Codec):
    """LOSSLESS dictionary coding for low-cardinality integer/bool
    slabs: uint8 indices on the wire and the slab's sorted values, padded
    to 256 entries, as the sidecar; decode is one gather.  More than 256
    distinct values in a slab raise."""

    name = "dict"
    lossless = True
    sidecar = True

    def wire_dtype(self, dtype):
        dtype = np.dtype(dtype)
        if not (np.issubdtype(dtype, np.integer)
                or dtype == np.dtype(np.bool_)):
            self._refuse(dtype, "dictionary coding is defined for "
                                "integer/bool sources only — float "
                                "values are not dictionary-shaped "
                                "(use bf16/f16/int8/delta-f32 for "
                                "float pipelines)")
        return torch.uint8

    def encode(self, block, delta_ok=True):
        block = np.asarray(block)
        self.wire_dtype(block.dtype)
        values, inverse = np.unique(block, return_inverse=True)
        if values.size > 256:
            raise ValueError(
                "codec 'dict' needs <= 256 distinct values per slab, "
                "got %d: dictionary coding is for low-cardinality "
                "key/label columns — stream this source uncompressed"
                % values.size)
        # padded to 256 entries so every slab shares one geometry
        table = np.empty(256, block.dtype)
        table[:values.size] = values
        table[values.size:] = values[-1] if values.size else 0
        wire = inverse.reshape(block.shape).astype(np.uint8)
        return torch.from_numpy(wire), (table,)

    def decode(self, wire, sidecar, dtype, delta_ok=True):
        return sidecar[0][wire.to(torch.int64)].to(dtype)


class _DeltaF32Codec(Codec):
    """LOSSLESS codec for float32 pipelines: the raw bits are delta-coded
    along the trailing value axis with wraparound 32-bit subtraction;
    decode is the wraparound cumsum and a bit cast, so the decoded bits
    equal the raw bits (NaN payloads too).  An all-key-axes source
    (``delta_ok=False``) ships the raw bits."""

    name = "delta-f32"
    lossless = True

    def wire_dtype(self, dtype):
        dtype = np.dtype(dtype)
        if dtype != np.dtype(np.float32):
            self._refuse(dtype, "the bit-plane delta transform is "
                                "defined for float32 sources only")
        return torch.int32

    def encode(self, block, delta_ok=True):
        block = np.asarray(block)
        self.wire_dtype(block.dtype)
        u = np.ascontiguousarray(block).view(np.uint32)
        if not delta_ok or u.shape[-1] < 2:
            d = u.copy()
        else:
            d = u.copy()
            d[..., 1:] = u[..., 1:] - u[..., :-1]     # uint32 wraparound
        return torch.from_numpy(d.view(np.int32)), ()

    def decode(self, wire, sidecar, dtype, delta_ok=True):
        bits = wire
        if delta_ok and wire.shape[-1] >= 2:
            # the int64 cumsum of the sign-extended deltas is the uint32
            # wraparound cumsum modulo 2**32; fold it into int32's range
            acc = torch.cumsum(wire.to(torch.int64), dim=-1)
            acc.add_(1 << 31).bitwise_and_(0xFFFFFFFF).sub_(1 << 31)
            bits = acc.to(torch.int32)
        return bits.view(torch.float32)


# ---------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------

_REGISTRY = {}


def register(codec):
    """Register a codec instance under its ``name``."""
    if not codec.name:
        raise ValueError("codec must carry a non-empty .name")
    _REGISTRY[codec.name] = codec
    return codec


def names():
    """The registered codec names, sorted."""
    return tuple(sorted(_REGISTRY))


def get(name):
    """The registered codec for ``name`` (a :class:`Codec` instance
    passes through); a pointed ``ValueError`` naming the known codecs
    otherwise."""
    if isinstance(name, Codec):
        return name
    c = _REGISTRY.get(name)
    if c is None:
        raise ValueError("unknown codec %r (known: %s)"
                         % (name, ", ".join(names())))
    return c


register(_CastCodec("bf16", torch.bfloat16, _cast_bf16))
register(_CastCodec("f16", torch.float16, _cast_f16))
register(_Int8Codec())
register(_DeltaF32Codec())
register(_DictCodec())


def kernel_enabled():
    """True when ``BOLT_CODEC_KERNEL=1`` arms the hand-written
    decode-and-reduce kernel: a streamed int8 ``sum`` with no stages then
    decodes inside ``bolt_tpu_torch.ops.kernels.fused_decode_sum``."""
    return os.environ.get("BOLT_CODEC_KERNEL", "0").lower() in ("1",
                                                                "true")
