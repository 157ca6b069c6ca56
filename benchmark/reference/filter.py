"""``filter``: ``mean_gt`` keeps the records whose mean exceeds
``value``.  In f64 a record whose mean lies within ``BAND`` of the bound
is ambiguous: an f32 mean of it may fall either side, and either answer
is right (``reference/sum.py`` finds which side the program took).  A
control keeps what its own precision decides."""

# an f32 mean of 819200 values near 1 errs by about 1e-7; a hundred times
# that, so no record the program may decide either way is called certain
BAND = 1e-5


def apply(x, params, ctx):
    if params["fn"] != "mean_gt":
        raise ValueError("no reference for filter fn %r" % params["fn"])
    bound = params["value"]
    band = BAND if ctx.mode == "reference" else 0.0

    def pred(blk):
        m = blk.mean(dim=tuple(range(1, blk.ndim)))
        if band == 0.0:
            return m > bound, m != m        # nothing ambiguous
        return m > bound + band, (m - bound).abs() <= band

    return x.where(pred)
