"""A run with the timed path broken underneath comes out not correct:
for each cell, half of the batch left out (the statistic taken over the
rest) and an answer altered where it is produced."""

import pytest

from conftest import small


def _scaled_half(orig):
    def half_sum(self, *a, **k):
        n = self.shape[0]
        out = orig(self[: n // 2], *a, **k).cache()
        out.totorch().mul_(n / (n // 2))
        return out
    return half_sum


def _half_stats(orig):
    def half_stats(self, *a, **k):
        return orig(self[: self.shape[0] // 2], *a, **k)
    return half_stats


def _half_pca(orig):
    def half_pca(b, *a, **k):
        _, vec, sv = orig(b[: b.shape[0] // 2], *a, **k)
        scores = orig(b, *a, **k)[0]
        return scores, vec, sv
    return half_pca


def _altered(orig, pick):
    def altered(*a, **k):
        out = orig(*a, **k)
        t = pick(out)
        t[(0,) * t.ndim] += 0.05 * (float(t.abs().max()) + 1.0)
        return out
    return altered


def _array_method(name):
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    return BoltArrayGPU, name


def _ops(name):
    import bolt_tpu_torch.ops
    return bolt_tpu_torch.ops, name


def _sum_tensor(out):
    return out.cache().totorch()


FAULTS = {
    ("ns.fused", "half"): (_array_method, "sum", _scaled_half),
    ("ns.fused", "altered"): (_array_method, "sum",
                              lambda o: _altered(o, _sum_tensor)),
    ("img.path", "half"): (_array_method, "stats", _half_stats),
    ("img.path", "altered"): (_ops, "gaussian",
                              lambda o: _altered(o, lambda r: r.totorch())),
    ("ns.series", "half"): (_array_method, "sum", _scaled_half),
    ("ns.series", "altered"): (_array_method, "swap",
                               lambda o: _altered(o, lambda r: r.totorch())),
    ("img.pca", "half"): (_ops, "pca", _half_pca),
    ("img.pca", "altered"): (_ops, "pca",
                             lambda o: _altered(o, lambda r: r[1])),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    from benchmark import harness
    where, name, wrap = FAULTS[(cell, fault)]
    owner, attr = where(name)
    monkeypatch.setattr(owner, attr, wrap(getattr(owner, attr)))
    res, lines = harness.run_cell(cell, 99, 0.2, 0, device="cpu",
                                  overrides=small(cell))
    assert res["failed"] == 0, lines
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["ns.fused", "img.path", "ns.series",
                                  "img.pca"])
def test_the_same_run_unbroken_is_correct(cell):
    from benchmark import harness
    res, _ = harness.run_cell(cell, 99, 0.2, 0, device="cpu",
                              overrides=small(cell))
    assert res["correct"] is True, res["checks"]
