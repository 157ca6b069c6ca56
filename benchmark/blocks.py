"""A dataset drawn in blocks of records along its first axis, for a cell
run as a pod.  Block ``b`` of a run comes from a generator seeded by
``(seed, b)`` alone, so a rank draws only the blocks of its own box and
the same blocks come out whatever the number of ranks; the reference
draws them again one at a time (:class:`Blocks`).  The block size is
the configuration's ``block_records``.  Imports nothing of the
program."""

import numpy as np

# values of each block that stand for it when two draws are compared
FINGERPRINT = 64


def block_seed(seed, b):
    """The generator seed of block ``b`` of the run seeded ``seed``."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(b)])
    lo, hi = state.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def layout(config):
    """``(records, record shape, block_records)`` of a blocked dataset;
    raises for a configuration blocks cannot draw."""
    if config["data"] != "randn" or config.get("planted"):
        raise ValueError("blocks draw plain standard normals only")
    if sorted(config["key_axes"]) != [0]:
        raise ValueError("blocks run along key axis 0 alone, not %s"
                         % config["key_axes"])
    shape = tuple(config["shape"])
    per = int(config["block_records"])
    if shape[0] % per:
        raise ValueError("%d records do not split into blocks of %d"
                         % (shape[0], per))
    return shape[0], shape[1:], per


def draw(torch, seed, b, out):
    """Block ``b`` drawn into ``out`` (contiguous, its device's
    generator) in one call."""
    g = torch.Generator(device=out.device)
    g.manual_seed(block_seed(seed, b))
    return out.normal_(generator=g)


def fingerprint(blk):
    flat = blk.reshape(-1)
    step = max(1, flat.numel() // FINGERPRINT)
    return flat[::step][:FINGERPRINT].clone()


def draw_box(torch, config, seed, lo, hi, device):
    """Records ``[lo, hi)`` of the dataset on ``device``, whole blocks
    only, and the fingerprint of each block, ``{b: values}``."""
    _, vshape, per = layout(config)
    if lo % per or hi % per:
        raise ValueError("a box [%d, %d) that does not hold whole blocks "
                         "of %d records" % (lo, hi, per))
    x = torch.empty((hi - lo,) + vshape, dtype=getattr(torch, config["dtype"]),
                    device=device)
    prints = {}
    for b in range(lo // per, hi // per):
        blk = x[b * per - lo:(b + 1) * per - lo]
        draw(torch, seed, b, blk)
        prints[b] = fingerprint(blk)
    return x, prints


class Blocks:
    """The whole dataset as ``reference/plain.RefArray`` reads its base
    (``blocks()``): a shape, a device, and runs of records of the first
    axis, each block drawn from the seed when it is read, one held at a
    time.  ``prints`` keeps each block's fingerprint from its first
    draw."""

    def __init__(self, torch, config, seed, device):
        self.torch, self.seed, self.device = torch, seed, torch.device(device)
        self.records, self.vshape, self.per = layout(config)
        self.shape = (self.records,) + self.vshape
        self.dtype = getattr(torch, config["dtype"])
        self.prints = {}
        self._held = (None, None)

    def block(self, b):
        if self._held[0] != b:
            self._held = (None, None)
            out = self.torch.empty((self.per,) + self.vshape,
                                   dtype=self.dtype, device=self.device)
            draw(self.torch, self.seed, b, out)
            self.prints.setdefault(b, fingerprint(out))
            self._held = (b, out)
        return self._held[1]

    def __getitem__(self, index):
        """Records ``index`` (a forward slice of the first axis)."""
        if not isinstance(index, slice):
            raise IndexError("blocks serve a run of records, not %r"
                             % (index,))
        i, j, step = index.indices(self.records)
        if step != 1 or j <= i:
            raise IndexError("blocks serve a forward run of records")
        parts = [self.block(b)[max(i, b * self.per) - b * self.per:
                               min(j, (b + 1) * self.per) - b * self.per]
                 for b in range(i // self.per, (j - 1) // self.per + 1)]
        return parts[0] if len(parts) == 1 else self.torch.cat(parts)
