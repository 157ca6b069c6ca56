"""The general generator: a traffic mix's branches, each a chain of
steps from the resident dataset or an earlier branch's result, run as
one pass of the program.  Each step is ``ops/<step>.py``."""

import contextlib
from math import prod

from benchmark import common
from benchmark.tracing import PREFIX


class Pass:
    def __init__(self, traffic, data, seed):
        self.data = data
        self.seed = seed
        self.branches = []
        for br in traffic["branches"]:
            steps = []
            for name, params in br["steps"]:
                mod = common.piece("ops", name)
                state = mod.prepare(params) if hasattr(mod, "prepare") \
                    else None
                steps.append((name, mod, params, state))
            self.branches.append((br["range"], br["from"], br["as"], steps))

    def __call__(self, ranges=False):
        """Run every branch once; returns ``{(range, step): output}``
        (what the caller keeps alive until the pass is judged or
        dropped).  ``ranges`` wraps each branch in a profiler range."""
        env = {"data": self.data}
        outs = {}
        for label, src, dst, steps in self.branches:
            cm = _range(PREFIX + label) if ranges else contextlib.nullcontext()
            with cm:
                x = env[src]
                for name, mod, params, state in steps:
                    x = mod.run(x, state, params)
                    outs[(label, name)] = (mod, x)
            env[dst] = x
        return outs

    def keep(self, outs):
        """What a comparison reads of one pass's outputs: small copies,
        the records of each array drawn from the seed."""
        kept = {}
        for (label, name), (mod, out) in outs.items():
            if not hasattr(mod, "keep"):
                continue
            tag = "%s.%s" % (label, name)

            def sample(split, shape, tag=tag):
                return common.sample(self.seed, tag, prod(shape[:split]),
                                     4 * prod(shape[split:]))
            kept[(label, name)] = mod.keep(out, sample)
        return kept


def _range(name):
    from torch.profiler import record_function
    return record_function(name)
