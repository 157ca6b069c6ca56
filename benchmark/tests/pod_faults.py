"""A pod worker with a fault planted before it runs, for the tests of
the broken paths:

    python3 pod_faults.py <fault> <rank> <run directory>

The folds' faults (``FAULTS``) break every rank alike; ``kill``: rank 1
kills itself in its second timed pass; ``stuck``: rank 1 stops there
for good."""

import os
import signal
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, pod  # noqa: E402
from benchmark.pipeline import Pass  # noqa: E402


def _fold(pick):
    """Every fold of the pod over the partials ``pick(every rank's)``."""
    from bolt_tpu_torch.parallel import multihost

    def folded(tree, combine, group):
        trees = pick(tree, multihost.all_gather(tree, group))
        acc = trees[0]
        for t in trees[1:]:
            acc = combine(acc, t)
        return acc
    multihost.fold_partials = folded


def _altered(tree):
    from bolt_tpu_torch.parallel import multihost
    leaf = multihost._leaves(tree, [])[0]
    leaf.view(-1)[0] += 0.05 * (float(leaf.abs().max()) + 1.0)
    return tree


def _at_pass(rank, act):
    """``act()`` on rank 1 in its second timed pass."""
    if rank != 1:
        return
    orig = Pass.__call__
    calls = [0]

    def call(self, *a, **k):
        calls[0] += 1
        if calls[0] == harness.WARMUP + 2:
            act()
        return orig(self, *a, **k)
    Pass.__call__ = call


FAULTS = {
    # the last rank's partial left out of every fold
    "drop_last": lambda rank: _fold(lambda mine, every: every[:-1]),
    # no exchange: each rank folds its own partial alone
    "no_exchange": lambda rank: _fold(lambda mine, every: [mine]),
    # half the ranks' partials stand for all of them
    "half": lambda rank: _fold(
        lambda mine, every: every[:len(every) // 2] * 2),
    # an answer altered where the fold produces it
    "altered": lambda rank: _fold(
        lambda mine, every: [_altered(every[0])] + every[1:]),
    "kill": lambda rank: _at_pass(
        rank, lambda: os.kill(os.getpid(), signal.SIGKILL)),
    "stuck": lambda rank: _at_pass(rank, lambda: time.sleep(3600)),
}

if __name__ == "__main__":
    fault, rank, run_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    FAULTS[fault](rank)
    sys.exit(pod.worker(rank, run_dir))
