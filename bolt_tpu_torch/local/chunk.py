"""Local-backend chunking: the NumPy oracle for the chunk semantics.

The reference only has ``ChunkedArray`` on the distributed backend
(``bolt/spark/chunk.py``; symbol-level citation, SURVEY.md §0) — local users
had no way to run chunked code without a SparkContext.  This view closes
that asymmetry: the same ``chunk(size, axis, padding) → map → unchunk``
contract (plans, halo padding, ragged tails, ``keys_to_values`` /
``values_to_keys``) executes on plain NumPy, so mode-agnostic user code and
the parity tests have a local oracle for every chunked operation.

Unlike :class:`bolt_tpu_torch.gpu.chunk.ChunkedArray` (a zero-copy plan over the
mesh-resident array), this implementation really materialises each block —
clarity over speed; it is the semantic reference, not a fast path.
"""

from itertools import product as _product

import numpy as np

from bolt_tpu_torch.utils import (check_value_shape, chunk_align, chunk_pad,
                            chunk_plan, iterexpand, prod, tupleize)


class LocalChunkedArray:
    """A chunk view over a NumPy array whose leading ``split`` axes are
    keys.  Mirrors the device :class:`~bolt_tpu_torch.gpu.chunk.ChunkedArray`
    surface (minus ``shard``, which needs a mesh)."""

    def __init__(self, data, split, plan, padding):
        self._data = np.asarray(data)
        self._split = int(split)
        self._plan = tuple(int(p) for p in plan)
        self._padding = tuple(int(p) for p in padding)

    @classmethod
    def chunk(cls, data, split, size="150", axis=None, padding=None):
        data = np.asarray(data)
        vshape = data.shape[split:]
        axes, size, padding = chunk_align(vshape, axis, size, padding)
        plan = chunk_plan(vshape, data.dtype.itemsize, size, axes,
                          padding=padding)
        pad = chunk_pad(plan, axes, padding, vshape)
        return cls(data, split, plan, pad)

    # ------------------------------------------------------------------
    # properties (same contract as the device view)
    # ------------------------------------------------------------------

    @property
    def plan(self):
        return self._plan

    @property
    def padding(self):
        return self._padding

    @property
    def kshape(self):
        return self._data.shape[:self._split]

    @property
    def vshape(self):
        return self._data.shape[self._split:]

    @property
    def shape(self):
        return self._data.shape

    @property
    def split(self):
        return self._split

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def mode(self):
        return "local"

    @property
    def grid(self):
        return tuple(-(-v // c) for v, c in zip(self.vshape, self._plan))

    @property
    def uniform(self):
        return all(v % c == 0 for v, c in zip(self.vshape, self._plan))

    # ------------------------------------------------------------------
    # per-block map
    # ------------------------------------------------------------------

    def map(self, func, value_shape=None, dtype=None):
        """Apply ``func`` to every chunk of every record.

        Same contract as the device view: with a uniform plan and no padding
        the block shape may change (rank-preserving); with padding or a
        ragged tail ``func`` must preserve the block shape so the halo can
        be trimmed and the tiles reassembled.
        """
        vshape = self.vshape
        nv = len(vshape)
        plan = self._plan
        pad = self._padding
        grid = self.grid
        shape_change_ok = self.uniform and not any(pad)
        flat = self._data.reshape((prod(self.kshape),) + vshape)

        def one_record(rec):
            cells = {}
            for gi in _product(*[range(g) for g in grid]):
                core0 = [gi[i] * plan[i] for i in range(nv)]
                core1 = [min(vshape[i], core0[i] + plan[i]) for i in range(nv)]
                lo = [max(0, core0[i] - pad[i]) for i in range(nv)]
                hi = [min(vshape[i], core1[i] + pad[i]) for i in range(nv)]
                blk = rec[tuple(slice(lo[i], hi[i]) for i in range(nv))]
                out = np.asarray(func(blk))
                if shape_change_ok:
                    if out.ndim != nv:
                        raise ValueError(
                            "chunked map must preserve block rank: block %s "
                            "-> %s" % (str(blk.shape), str(out.shape)))
                    cells[gi] = out
                else:
                    if out.shape != blk.shape:
                        raise ValueError(
                            "with padding or a ragged chunk plan, the mapped "
                            "function must preserve the block shape; got %s "
                            "-> %s" % (str(blk.shape), str(out.shape)))
                    cells[gi] = out[tuple(
                        slice(core0[i] - lo[i], core0[i] - lo[i]
                              + core1[i] - core0[i]) for i in range(nv))]

            def assemble(prefix, level):
                if level == nv:
                    return cells[tuple(prefix)]
                return np.concatenate(
                    [assemble(prefix + [i], level + 1)
                     for i in range(grid[level])], axis=level)
            return assemble([], 0)

        if flat.shape[0]:
            out = np.stack([one_record(rec) for rec in flat])
        else:
            # zero records: the empty result must still carry the value
            # shape func WOULD produce, inferred by running it on a zeros
            # probe (the device path infers on meta tensors; this backend executes
            # func for real — silence the numeric warnings an all-zeros
            # block can trigger in funcs that divide/log their input)
            with np.errstate(all="ignore"):
                probe = one_record(np.zeros(vshape, self._data.dtype))
            out = np.zeros((0,) + probe.shape, probe.dtype)
        check_value_shape(value_shape, tuple(
            o // g for o, g in zip(out.shape[1:], grid)) if shape_change_ok
            else tuple(plan))
        if dtype is not None:
            out = out.astype(dtype)
        out = out.reshape(self.kshape + out.shape[1:])
        new_plan = (tuple(o // g for o, g in
                          zip(out.shape[self._split:], grid))
                    if shape_change_ok else plan)
        return LocalChunkedArray(out, self._split, new_plan, pad)

    # ------------------------------------------------------------------
    # axis exchange (same algebra as the device view / reference swap)
    # ------------------------------------------------------------------

    def keys_to_values(self, axes, size=None):
        """Move key axes into the values (landing at the FRONT of the value
        group, in the order given).  Moving every key axis is allowed; the
        result has ``split=0`` until ``values_to_keys`` restores keys."""
        axes = tuple(tupleize(axes))
        split = self._split
        for a in axes:
            if a < 0 or a >= split:
                raise ValueError(
                    "key axis %d out of range for split %d" % (a, split))
        if len(set(axes)) != len(axes):
            raise ValueError("keys_to_values axes must be unique")
        keys_rest = [k for k in range(split) if k not in axes]
        nv = len(self.vshape)
        perm = keys_rest + list(axes) + [split + v for v in range(nv)]
        data = np.transpose(self._data, perm)
        moved = [self._data.shape[a] for a in axes]
        if size is not None:
            sizes = iterexpand(size, len(moved))
            for s in sizes:
                if int(s) < 1:
                    raise ValueError(
                        "chunk size must be >= 1, got %d" % int(s))
            moved = [min(int(s), m) for s, m in zip(sizes, moved)]
        return LocalChunkedArray(
            data, len(keys_rest), tuple(moved) + self._plan,
            (0,) * len(axes) + self._padding)

    def values_to_keys(self, axes):
        """Move value axes into the keys (appended after the existing key
        axes, in the order given)."""
        axes = tuple(tupleize(axes))
        nv = len(self.vshape)
        for a in axes:
            if a < 0 or a >= nv:
                raise ValueError(
                    "value axis %d out of range for %d value axes" % (a, nv))
        if len(set(axes)) != len(axes):
            raise ValueError("values_to_keys axes must be unique")
        split = self._split
        keep = [i for i in range(nv) if i not in axes]
        perm = (list(range(split)) + [split + v for v in axes]
                + [split + v for v in keep])
        data = np.transpose(self._data, perm)
        return LocalChunkedArray(
            data, split + len(axes), tuple(self._plan[i] for i in keep),
            tuple(self._padding[i] for i in keep))

    # ------------------------------------------------------------------

    def unchunk(self):
        """Back to a :class:`~bolt_tpu_torch.local.array.BoltArrayLocal` — the
        data never left its assembled layout."""
        from bolt_tpu_torch.local.array import BoltArrayLocal
        return BoltArrayLocal(self._data)

    def __repr__(self):
        s = "ChunkedArray\n"
        s += "mode: local\n"
        s += "shape: %s\n" % str(self.shape)
        s += "split: %d\n" % self.split
        s += "plan: %s\n" % str(self._plan)
        s += "padding: %s\n" % str(self._padding)
        s += "grid: %s\n" % str(self.grid)
        return s
