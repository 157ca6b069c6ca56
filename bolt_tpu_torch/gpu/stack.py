"""Stacking: batching flat key records into blocks.

Port of ``bolt_tpu/tpu/stack.py`` (reference: ``bolt/spark/stack.py ::
StackedArray``).  ``stacked(size)`` groups consecutive records' values
into ``(size, *value_shape)`` blocks so a user function sees a batch of
records at once; ``map`` applies it block-wise (it must preserve the
record count) and ``unstack`` returns the records.

On the card the blocks run in groups: ``torch.func.vmap(func)`` over as
many whole blocks as fit in about ``gpu/array.py :: _BLOCK_BYTES`` of
records (at least one block), ``func`` once more on the ragged tail, so
``stacked(1000).map(f)`` over an array of many GB never holds the whole
mapped chain and the whole output at once.  ``func`` runs once per group
and once on the tail: at most twice when the array fits one group,
whatever the block count.
"""

import torch
from torch.func import vmap

from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.gpu.array import (BoltArrayGPU, _block_records,
                                      _chain_donate_ok, _chain_rec_bytes,
                                      _map_blocks, _meta, _traceable,
                                      torch_dtype)
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.utils import check_value_shape, prod


def _cached_jit(key, builder):
    """Keyed program dispatch through the engine (patched per module by
    ``bolt_tpu_torch.profile.instrument``)."""
    return _engine.get(key, builder)


def _stack_map_body(data, func, split, size, canon=None):
    """The block-batched map: flatten the records, vmap ``func`` over the
    full blocks of ``size`` records, call it once on the ragged tail,
    restore the keys and cast to ``canon`` if asked.  Zero records: the
    output shape and dtype come from ``func`` on a meta block, and
    ``func`` never runs on data."""
    kshape = tuple(data.shape[:split])
    vshape = tuple(data.shape[split:])
    n = prod(kshape)
    flat = data.reshape((n,) + vshape)
    if n == 0:
        ob = func(_meta((size,) + vshape, flat.dtype))
        return torch.zeros(kshape + tuple(ob.shape[1:]),
                           dtype=canon or ob.dtype, device=data.device)
    nfull = n // size
    outs = []
    if nfull:
        blocks = flat[:nfull * size].reshape((nfull, size) + vshape)
        out = vmap(func)(blocks)
        if out.ndim < 2 or tuple(out.shape[:2]) != (nfull, size):
            got = out.shape[1] if out.ndim >= 2 else "none"
            raise ValueError(
                "stacked map must preserve the record count: "
                "block of %d records -> %s" % (size, got))
        outs.append(out.reshape((nfull * size,) + tuple(out.shape[2:])))
    if n % size:
        tail = flat[nfull * size:]
        tout = func(tail)
        if tout.ndim < 1 or tout.shape[0] != tail.shape[0]:
            raise ValueError(
                "stacked map must preserve the record count: "
                "block of %d records -> %s"
                % (tail.shape[0], tout.shape[0] if tout.ndim else "none"))
        outs.append(tout)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    out = out.reshape(kshape + tuple(out.shape[1:]))
    return out if canon is None else out.to(canon)


class StackedArray:
    """A block-batched view over a
    :class:`~bolt_tpu_torch.gpu.array.BoltArrayGPU`."""

    def __init__(self, barray, size):
        self._barray = barray
        self._size = int(size)

    @classmethod
    def stack(cls, barray, size=1000):
        if int(size) < 1:
            raise ValueError("stack size must be >= 1, got %r" % (size,))
        return cls(barray, size)

    @property
    def shape(self):
        return self._barray.shape

    @property
    def split(self):
        return self._barray.split

    @property
    def dtype(self):
        return self._barray.dtype

    @property
    def mode(self):
        return "gpu"

    @property
    def size(self):
        """Records per block (reference: the ``_stack(size)`` argument)."""
        return self._size

    @property
    def nblocks(self):
        n = prod(self.shape[:self.split])
        return -(-n // self._size)

    def map(self, func, value_shape=None, dtype=None):
        """Apply ``func`` block-wise: it receives ``(n, *value_shape)`` and
        must return ``(n, *new_value_shape)`` — record counts are
        preserved, as the reference requires for ``unstack`` to restore
        keys.  The ``value_shape``/``dtype`` hints are checked before any
        work on the card.  A sole-owned deferred chain donates its base:
        a result that keeps the record shape and dtype is written into
        the base's storage, group by group in record order, and the
        consumed array raises on later reads."""
        func = _traceable(func)
        b = self._barray
        _engine.strict_guard(b, "stacked().map()")
        if b._stream is not None:
            raise NotImplementedError(
                "stacked().map() on a streamed source is not ported yet "
                "(ROADMAP A9: the streamed stacked stage); materialise "
                "the stream first with .cache()")
        canon = None if dtype is None else torch_dtype(dtype)
        split = b.split
        vshape = tuple(b.shape[split:])
        n = prod(b.shape[:split])
        size = self._size
        if value_shape is not None:
            # the per-record output shape is the block's minus its axis
            ob = func(_meta((min(size, n) or size,) + vshape,
                            torch_dtype(b.dtype)))
            check_value_shape(value_shape, tuple(ob.shape[1:]))
        b._guard_donated()
        # donating terminal (checked before the base local exists)
        donate = b.deferred and _chain_donate_ok(b._chain)
        base, funcs = b._chain_parts()
        mapped_rec = _chain_rec_bytes(base, split, b.shape, b.dtype)

        def body(recs):
            return _stack_map_body(recs, func, 1, size, canon)

        def build():
            def run(data):
                if not prod(data.shape[:split]):
                    return _stack_map_body(data, func, split, size, canon)
                # groups of whole blocks, about _BLOCK_BYTES of records
                per = max(1, _block_records(mapped_rec) // size) * size
                return _map_blocks(data, funcs, split, body, per, donate)
            return run

        fn = _cached_jit(("stack-map", func, funcs, tuple(base.shape),
                          str(base.dtype), split, size, canon, donate,
                          b.device), build)
        with _obs.span("stack.map", size=size, donate=donate):
            out = fn(base)
        if donate:
            del base
            b._consume_donated("stacked().map()")
        return StackedArray(BoltArrayGPU(out, split, b.device), size)

    def unstack(self):
        """Back to a :class:`~bolt_tpu_torch.gpu.array.BoltArrayGPU`
        (reference: ``StackedArray.unstack``); a no-op unwrap here."""
        return self._barray

    def __repr__(self):
        s = "StackedArray\n"
        s += "mode: gpu\n"
        s += "shape: %s\n" % str(self.shape)
        s += "split: %d\n" % self.split
        s += "size: %d\n" % self._size
        s += "nblocks: %d\n" % self.nblocks
        return s
