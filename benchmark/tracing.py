"""The traced run's reading of ``torch.profiler``: device time by the
benchmark's own ranges, the device's busy share, the longest idle gaps
by what the host was doing, and the count of the port's kernels that
the trace saw, held against ``ops.kernels.LAUNCHES``.

Which kernels a ``LAUNCHES`` key launches is data: each
``benchmark/kernels/<group>.json`` names the keys it covers
(``launches``) and the kernel that opens each of their launches
(``kernels``; a combine kernel that follows is not named).  A kernel
the port adds, or one it renames, is one more file."""

import bisect
import glob
import json
import os
import re

PREFIX = "bench."
WINDOW = PREFIX + "window"
TOP = 10
KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")


def kernel_groups(folder=KERNELS):
    """``{group: {"launches": [keys], "kernels": [names]}}`` of every file
    in ``folder``."""
    groups = {}
    for path in sorted(glob.glob(os.path.join(folder, "*.json"))):
        with open(path) as f:
            groups[os.path.basename(path)[:-len(".json")]] = json.load(f)
    return groups


def _matcher(groups):
    """``name -> group or None``: the group whose kernel the device
    operation ``name`` is (a whole identifier of the demangled name)."""
    pats = [(g, re.compile(r"(?<![A-Za-z0-9_])(%s)(?![A-Za-z0-9_])"
                           % "|".join(re.escape(k) for k in v["kernels"])))
            for g, v in groups.items() if v.get("kernels")]

    def match(name):
        for g, pat in pats:
            if pat.search(name):
                return g
        return None
    return match


def cross_check(groups, seen, launched):
    """What keeps the trace from standing: ``seen`` (``{group: kernels
    the trace holds}``) against ``launched`` (``{key: LAUNCHES in the
    window}``), a list of faults, empty where they agree."""
    faults = []
    owner = {}
    for g, v in sorted(groups.items()):
        for k in v.get("launches", ()):
            if k in owner:
                faults.append("LAUNCHES key %r is in both kernels/%s.json "
                              "and kernels/%s.json" % (k, owner[k], g))
            owner[k] = g
    for k, n in sorted(launched.items()):
        if n and k not in owner:
            faults.append("%d launches of %r, which no kernels/<group>.json "
                          "names" % (n, k))
    for g, v in sorted(groups.items()):
        want = sum(launched.get(k, 0) for k in v.get("launches", ()))
        if seen.get(g, 0) != want:
            faults.append("the trace holds %d kernels of group %r where "
                          "LAUNCHES counted %d" % (seen.get(g, 0), g, want))
    return faults


def _is_device(e):
    return "cuda" in str(e.device_type()).lower()


# a range that a library opens on the card's timeline around its own work
# (``nccl:all_gather``, torch's NCCL process group): no operation
ANNOTATION = re.compile(r"^[A-Za-z0-9_]+:[A-Za-z0-9_]+$")


def is_operation(name):
    """Whether the device event ``name`` is a kernel, copy or fill: not a
    range (the benchmark's or a library's annotation) and not a
    synchronisation marker."""
    return not (name.startswith(PREFIX) or ANNOTATION.match(name)
                or any(w in name.lower() for w in ("sync", "wait")))


class Summary:
    """What one profiled window shows.  ``window_s``: the window's host
    span; ``busy_s``: the union of device operations inside it;
    ``by_range``: ``{label: [calls, device seconds]}``; ``device_ops``
    and ``idle_gaps``: the breakdown's lists; ``launches``: ``{group:
    kernels seen}`` of ``groups`` (see :func:`kernel_groups`)."""

    def __init__(self, events, groups=None):
        match = _matcher(kernel_groups() if groups is None else groups)
        host, dev = [], []
        window = None
        cpu_start = {}
        gpu_ranges = []
        for e in events:
            name = e.name()
            if _is_device(e):
                if name.startswith(PREFIX):
                    # the range as the card saw it (a user annotation)
                    gpu_ranges.append((e.start_ns(), e.end_ns(),
                                       name[len(PREFIX):]))
                elif is_operation(name):
                    dev.append((e.start_ns(), e.end_ns(), name,
                                e.linked_correlation_id()))
                continue
            cid = e.correlation_id()
            if cid:
                cpu_start[cid] = e.start_ns()
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif name.startswith(PREFIX):
                host.append((e.start_ns(), e.end_ns(), name[len(PREFIX):]))
        if window is None:
            raise RuntimeError("the trace holds no %r range" % WINDOW)
        w0, w1 = window
        self.window_s = (w1 - w0) * 1e-9
        host.sort()
        self._host = host
        self._starts = [h[0] for h in host]
        gpu_ranges.sort()
        self.by_range = {}
        for s, e, label in host:
            if w0 <= s <= w1:
                self.by_range.setdefault(label, [0, 0.0])[0] += 1
        self.unattributed_s = 0.0
        self.launches = {}
        per_name = {}
        spans = []
        for s, e, name, link in dev:
            if e < w0 or s > w1:
                continue
            dur = (e - s) * 1e-9
            per_name[name] = per_name.get(name, 0.0) + dur
            spans.append((max(s, w0), min(e, w1)))
            group = match(name)
            if group is not None:
                self.launches[group] = self.launches.get(group, 0) + 1
            label = None
            if link and link in cpu_start:
                label = self.host_label(cpu_start[link])
            if label is None:
                label = _containing(gpu_ranges, s, e)
            if label is None:
                self.unattributed_s += dur
            else:
                self.by_range.setdefault(label, [0, 0.0])[1] += dur
        spans.sort()
        busy = 0.0
        gaps = []
        cur0 = cur1 = None
        last = w0
        for s, e in spans:
            if cur1 is None or s > cur1:
                if cur1 is not None:
                    busy += (cur1 - cur0) * 1e-9
                gaps.append((last, s))
                cur0, cur1 = s, e
                last = e
            else:
                cur1 = max(cur1, e)
                last = cur1
        if cur1 is not None:
            busy += (cur1 - cur0) * 1e-9
        gaps.append((last, w1))
        self.busy_s = busy
        self.device_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle = {}
        for a, b in gaps:
            self._split_gap(a, b, idle)
        self.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]

    def _split_gap(self, a, b, idle):
        """Add the idle span ``[a, b]`` to ``idle`` by what the host was
        doing: each part inside a benchmark range under its label, the
        rest under "between passes"."""
        host = self._host
        i = max(0, bisect.bisect_right(self._starts, a) - 1)
        t = a
        while t < b:
            while i < len(host) and host[i][1] <= t:
                i += 1
            if i < len(host) and host[i][0] <= t:
                end, label = min(b, host[i][1]), host[i][2]
            else:
                end = min(b, host[i][0]) if i < len(host) else b
                label = "between passes"
            idle[label] = idle.get(label, 0.0) + (end - t) * 1e-9
            t = end

    def host_label(self, t):
        """The benchmark range open on the host at ``t``, or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self._host[i][0] <= t <= self._host[i][1]:
            return self._host[i][2]
        return None


def _containing(ranges, s, e):
    """The label of the device-side range (sorted by start) that holds
    the span ``[s, e]``, or None."""
    i = bisect.bisect_right(ranges, (s, float("inf"), "")) - 1
    if i >= 0 and ranges[i][0] <= s and e <= ranges[i][1]:
        return ranges[i][2]
    return None


def summarize(prof, groups=None):
    return Summary(prof.profiler.kineto_results.events(), groups)
