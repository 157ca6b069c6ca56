"""Streaming (single-pass, mergeable) statistics.

Reference: ``bolt/spark/statcounter.py :: StatCounter`` — adapted in the
reference from PySpark's Apache-licensed StatCounter; fields ``n, mu, m2,
maxValue, minValue`` with Welford ``merge`` and Chan ``mergeStats`` parallel
combine (symbol-level citation, SURVEY.md §0).  This implementation is
written fresh against the published Welford/Chan recurrences.

It operates elementwise over ndarrays, so a single counter tracks the
statistics of a whole value block.  The device backend computes the same
moments on the card (``bolt_tpu_torch/gpu/stats.py :: welford``), then
returns them wrapped in this class via :meth:`from_moments` — one
contract, two execution engines.
"""

import numpy as np

ALL_STATS = ("count", "mean", "var", "std", "min", "max")


class StatCounter:
    """Mergeable first/second-moment accumulator."""

    def __init__(self, values=(), stats="all"):
        self.n = 0
        self.mu = 0.0
        self.m2 = 0.0
        self.maxValue = -np.inf
        self.minValue = np.inf
        if stats == "all":
            stats = ALL_STATS
        self.requested = tuple(stats)
        for v in values:
            self.merge(v)

    # ------------------------------------------------------------------

    def _want(self, *names):
        return any(s in self.requested for s in names)

    def merge(self, value):
        """Fold one observation in (Welford update)."""
        value = np.asarray(value)
        self.n += 1
        if self._want("mean", "var", "std"):
            delta = value - self.mu
            self.mu = self.mu + delta / self.n
            if self._want("var", "std"):
                self.m2 = self.m2 + delta * (value - self.mu)
        if self._want("max"):
            self.maxValue = np.maximum(self.maxValue, value)
        if self._want("min"):
            self.minValue = np.minimum(self.minValue, value)
        return self

    def mergeStats(self, other):
        """Combine with another counter (Chan et al. parallel variance)."""
        if not isinstance(other, StatCounter):
            raise TypeError("can only merge another StatCounter")
        if other.n == 0:
            return self
        if self.n == 0:
            self.n = other.n
            self.mu = np.copy(other.mu) if isinstance(other.mu, np.ndarray) else other.mu
            self.m2 = np.copy(other.m2) if isinstance(other.m2, np.ndarray) else other.m2
            self.maxValue = other.maxValue
            self.minValue = other.minValue
            return self
        n = self.n + other.n
        if self._want("mean", "var", "std"):
            delta = np.asarray(other.mu) - np.asarray(self.mu)
            mu = self.mu + delta * (other.n / n)
            if self._want("var", "std"):
                self.m2 = (self.m2 + other.m2
                           + (delta ** 2) * self.n * other.n / n)
            self.mu = mu
        if self._want("max"):
            self.maxValue = np.maximum(self.maxValue, other.maxValue)
        if self._want("min"):
            self.minValue = np.minimum(self.minValue, other.minValue)
        self.n = n
        return self

    @classmethod
    def from_moments(cls, n, mu, m2, minValue=None, maxValue=None,
                     stats="all"):
        """Wrap precomputed moments (the device Welford path lands here)."""
        c = cls(stats=stats)
        c.n = int(n)
        c.mu = mu
        c.m2 = m2
        if minValue is not None:
            c.minValue = minValue
        if maxValue is not None:
            c.maxValue = maxValue
        return c

    # ------------------------------------------------------------------

    def count(self):
        return self.n

    def mean(self):
        return self.mu

    def variance(self):
        """Population variance (ddof=0), matching the reference."""
        if self.n == 0:
            return np.nan
        return self.m2 / self.n

    def sampleVariance(self):
        if self.n <= 1:
            return np.nan
        return self.m2 / (self.n - 1)

    def stdev(self):
        return np.sqrt(self.variance())

    def sampleStdev(self):
        return np.sqrt(self.sampleVariance())

    def max(self):
        return self.maxValue

    def min(self):
        return self.minValue

    def __repr__(self):
        return ("(count: %s, mean: %s, stdev: %s, max: %s, min: %s)"
                % (self.n, self.mu, self.stdev(), self.maxValue, self.minValue))
