"""The trace reader on a made-up window: the device's busy time is the
union of its operations, idle gaps carry the host's range, operations
go to the range that launched them, and the port's kernels are counted
once a launch."""

import pytest


class Ev:
    def __init__(self, name, start, end, device=False, corr=0, link=0):
        self._n, self._s, self._e = name, start, end
        self._d, self._c, self._l = device, corr, link

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def window():
    ms = 1_000_000
    return [
        Ev("bench.window", 0, 100 * ms, corr=1),
        Ev("bench.map_sum", 1 * ms, 10 * ms, corr=2),
        Ev("bench.group", 10 * ms, 60 * ms, corr=3),
        Ev("aten::sum", 11 * ms, 12 * ms, corr=4),
        # launched in map_sum: the partial and its combine kernel
        Ev("void mr_cols_kernel<float, 4, 4, false>(...)", 2 * ms, 20 * ms,
           device=True, link=2),
        Ev("void mr_cols_combine_kernel<float>(...)", 20 * ms, 22 * ms,
           device=True, link=2),
        # launched in group, overlapping nothing; a copy; a sync marker
        Ev("void at::native::reduce_kernel<...>", 30 * ms, 50 * ms,
           device=True, link=4),
        Ev("Memcpy DtoH (Device -> Pageable)", 50 * ms, 55 * ms,
           device=True, link=4),
        Ev("Context Sync", 55 * ms, 90 * ms, device=True),
        # the card's own view of a range: not an operation
        Ev("bench.group", 30 * ms, 55 * ms, device=True),
        # no link: placed by the card's range that holds it
        Ev("void welford_partial_kernel<float, 4>(...)", 31 * ms, 32 * ms,
           device=True),
    ]


def test_busy_idle_and_ranges():
    from benchmark import tracing
    s = tracing.Summary(window())
    assert s.window_s == pytest.approx(0.1)
    # union: [2, 22] and [30, 55] ms
    assert s.busy_s == pytest.approx(0.045)
    # mr_cols and welford_partial; not the combine kernel
    assert s.launches == {"map_reduce": 1, "welford": 1}
    assert s.by_range["map_sum"] == [1, pytest.approx(0.020)]
    assert s.by_range["group"] == [1, pytest.approx(0.026)]
    assert s.unattributed_s == 0
    idle = dict(s.idle_gaps)
    # gaps [0, 2], [22, 30], [55, 100] split by the host's ranges:
    # map_sum [1, 2]; group [22, 30] and [55, 60]; none [0, 1], [60, 100]
    assert idle["map_sum"] == pytest.approx(0.001)
    assert idle["group"] == pytest.approx(0.013)
    assert idle["between passes"] == pytest.approx(0.041)
    names = [n for n, _ in s.device_ops]
    assert names[0].startswith("void at::native::reduce_kernel")
    assert names[1].startswith("void mr_cols_kernel") and len(names) == 5


def test_roofline_reads_the_declared_least_time():
    from benchmark import harness, peaks
    from benchmark import tracing
    s = tracing.Summary(window())
    spec = type("S", (), {})()
    ctx = harness.MetricContext(s, {"map_sum": (spec, spec, 33_500_000, 0)},
                                {}, {}, 1)
    want = 100 * peaks.least_seconds(33_500_000, 0) / 0.020
    assert ctx.roofline("map_sum") == pytest.approx(want)
    assert ctx.roofline("absent") is None
    assert s.host_label(5_000_000) == "map_sum"
    assert s.host_label(70_000_000) is None


def test_a_window_without_its_range_is_refused():
    from benchmark import tracing
    with pytest.raises(RuntimeError, match="bench.window"):
        tracing.Summary(window()[1:])


def test_kernel_counts_cross_check_by_group():
    from benchmark import tracing
    groups = tracing.kernel_groups()
    seen = tracing.Summary(window(), groups).launches
    launched = {"fused_map_reduce": 1, "fused_welford": 1, "fused_stats": 0}
    assert tracing.cross_check(groups, seen, launched) == []
    # a hole in the trace, a launch the trace never saw
    faults = tracing.cross_check(groups, seen,
                                 dict(launched, fused_map_reduce=2))
    assert len(faults) == 1 and "'map_reduce'" in faults[0]
    # a key no group names cannot be checked
    faults = tracing.cross_check(groups, seen, dict(launched, fused_new=3))
    assert len(faults) == 1 and "'fused_new'" in faults[0]


def test_every_kernel_of_the_port_is_named_once():
    from benchmark import tracing
    from bolt_tpu_torch.ops import kernels
    groups = tracing.kernel_groups()
    keys = [k for g in groups.values() for k in g["launches"]]
    assert sorted(keys) == sorted(kernels.LAUNCHES)


def test_a_kernel_is_added_by_a_file(tmp_path):
    import json
    import shutil
    from benchmark import tracing
    for f in sorted(tracing.kernel_groups()):
        shutil.copy("%s/%s.json" % (tracing.KERNELS, f), tmp_path)
    (tmp_path / "group_scan.json").write_text(json.dumps(
        {"launches": ["fused_group_scan"], "kernels": ["group_scan_kernel"]}))
    groups = tracing.kernel_groups(str(tmp_path))
    ms = 1_000_000
    events = window() + [
        Ev("void group_scan_kernel<float>(...)", 60 * ms, 61 * ms,
           device=True, link=3),
        # another identifier that only contains the name
        Ev("void group_scan_kernel_v2<float>(...)", 62 * ms, 63 * ms,
           device=True, link=3)]
    seen = tracing.Summary(events, groups).launches
    assert seen["group_scan"] == 1
    launched = {"fused_map_reduce": 1, "fused_welford": 1,
                "fused_group_scan": 1}
    assert tracing.cross_check(groups, seen, launched) == []
