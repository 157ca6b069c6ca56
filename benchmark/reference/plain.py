"""The reference's array and its evaluation of a pass.

A :class:`RefArray` is records (key axes first) of a base tensor with
per-record functions pending, computed block by block in the reference's
dtype, so an f64 reference of a 10.49 GB dataset fits beside nothing
else on the card.  :func:`evaluate` runs a traffic mix's branches step
by step through ``reference/<step>.py``; :func:`judge` holds what the
program kept against it."""

import contextlib
from math import prod

import torch

from benchmark import common

# f64 bytes a block of records may take
BLOCK_BYTES = 1 << 29


class RefArray:
    def __init__(self, base, split, dtype, funcs=(), pred=None):
        self.base, self.split, self.dtype = base, int(split), dtype
        self.funcs, self.pred = tuple(funcs), pred

    @property
    def kshape(self):
        return tuple(self.base.shape[:self.split])

    @property
    def vshape(self):
        return tuple(self.base.shape[self.split:])

    @property
    def nrec(self):
        return prod(self.kshape)

    def then(self, f):
        """``f`` applied to every block of records ``(b,) + vshape``."""
        return RefArray(self.base, self.split, self.dtype,
                        self.funcs + (f,), self.pred)

    def where(self, pred):
        """Records filtered by ``pred(block) -> (certain, ambiguous)``."""
        return RefArray(self.base, self.split, self.dtype, self.funcs, pred)

    def _apply(self, blk):
        blk = blk.to(self.dtype)
        for f in self.funcs:
            blk = f(blk)
        return blk

    def blocks(self):
        """``(start, stop, block)`` over the flat records, the block
        computed in the reference's dtype: whole rows of the first key
        axis at a time."""
        first = self.base.shape[0]
        row = prod(self.base.shape[1:]) * 8
        rows = max(1, BLOCK_BYTES // max(1, row))
        per_row = prod(self.kshape[1:])
        for i in range(0, first, rows):
            j = min(first, i + rows)
            blk = self.base[i:j].reshape((-1,) + self.vshape)
            yield i * per_row, j * per_row, self._apply(blk)

    def records(self, idx):
        """Records ``idx`` (flat over the key axes), computed."""
        keys = torch.unravel_index(torch.as_tensor(idx, device=self.base.device),
                                   self.kshape)
        return self._apply(self.base[keys])

    def materialize(self):
        out = torch.empty(self.base.shape, dtype=self.dtype,
                          device=self.base.device)
        flat = out.view((-1,) + self.vshape)
        for s, e, blk in self.blocks():
            flat[s:e] = blk
        return RefArray(out, self.split, self.dtype)

    def permute(self, perm, split):
        src = self.materialize() if self.funcs else self
        return RefArray(src.base.permute(perm), split, self.dtype)


@contextlib.contextmanager
def precision(control):
    """Matmuls in full f32 (the reference) or in TF32 (the "tf32"
    control); restored afterwards."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


DTYPES = {"reference": torch.float64, "bfloat16": torch.bfloat16,
          "tf32": torch.float32}


def evaluate(traffic, config, base, seed, mode="reference"):
    """``{(range, step): output}`` of every step that has a reference
    output, computing the pass over ``base`` (the dataset as the
    benchmark made it, key axes first) in ``mode``: ``"reference"``
    (f64), or a control, ``"bfloat16"`` or ``"tf32"``."""
    dtype = DTYPES[mode]
    spec = common.config_spec(config)
    env = {"data": RefArray(base, spec.split, dtype)}
    out = {}
    with precision(mode), torch.no_grad():
        for br in traffic["branches"]:
            x = env[br["from"]]
            for name, params in br["steps"]:
                mod = common.piece("reference", name)
                label = "%s.%s" % (br["range"], name)
                ctx = Context(seed, label, mode)
                res = mod.apply(x, params, ctx)
                if hasattr(mod, "output"):
                    out[(br["range"], name)] = mod.output(res, x, params, ctx)
                x = res
            env[br["as"]] = x
    return out


class Context:
    def __init__(self, seed, label, mode):
        self.seed, self.label, self.mode = seed, label, mode

    def sample(self, nrec, record_numel):
        return common.sample(self.seed, self.label, nrec, 4 * record_numel)


def judge(traffic, kept, ref):
    """``{number: value}``: every comparison of what the program kept in
    one pass (``{(range, step): outputs}``) against the reference's
    outputs; a missing output reads infinite."""
    numbers = {}
    for br in traffic["branches"]:
        for name, _ in br["steps"]:
            key = (br["range"], name)
            if key not in ref:
                continue
            mod = common.piece("reference", name)
            got = kept.get(key, "missing")
            if got is None:
                continue      # the program's side had nothing to keep
            for q, v in (mod.judge(got, ref[key]) if got != "missing"
                         else {"missing": float("inf")}).items():
                numbers["%s.%s" % (br["range"], q)] = v
    return numbers


def rel_gap(got, want):
    """Largest ``|got - want|`` over the largest ``|want|``."""
    got = torch.as_tensor(got).to(want.device, torch.float64)
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale > 0 else 1.0)
