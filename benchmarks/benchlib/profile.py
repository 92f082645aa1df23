"""The device's side of a traced run, from torch.profiler.

`Trace` holds what the per-layer readers need from a profile of a few
whole passes: the device operations (kernels, copies, sets) with their
intervals, the window (the span of the harness's `pass` ranges), the
device's busy seconds (the union of the intervals, so overlapping work
counts once), and the breakdown the result line carries: the device
operations that took most time, and the longest idle stretches named by
the harness span and the host operation under way when each began.
"""

from __future__ import annotations

import bisect
import collections

from . import stats

# the harness's own host ranges (record_function names)
SPANS = ("load", "pass", "chunk", "all_gather", "sgd_update")
NAME_CHARS = 96


def _short(name):
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.device_ops = []  # (start s, end s, name)
        spans, host = [], []
        for e in prof.events():
            a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == DeviceType.CUDA:
                if e.name not in SPANS:  # not the spans' device mirrors
                    self.device_ops.append((a, b, e.name))
            elif e.name in SPANS:
                spans.append((a, b, e.name))
            elif not e.name.startswith(("cudaLaunch", "cuLaunch")):
                # the op that launches, not the launch call, names a gap
                host.append((a, b, e.name))
        passes = [(a, b) for a, b, n in spans if n == "pass"]
        if passes:
            self.lo = min(a for a, _ in passes)
            self.hi = max(b for _, b in passes)
        else:
            self.lo = self.hi = 0.0
        self.spans = sorted(spans)
        self.host = sorted(host)

    @property
    def window_s(self):
        return self.hi - self.lo

    def busy_s(self):
        return stats.busy([(a, b) for a, b, _ in self.device_ops],
                          self.lo, self.hi)

    def kernels(self):
        """Device kernels in the window (copies and sets left out)."""
        return [(a, b, n) for a, b, n in self.device_ops
                if self.lo <= a <= self.hi
                and not n.startswith(("Memcpy", "Memset"))]

    def device_time(self, match):
        """Device seconds of the operations whose name holds match."""
        return sum(b - a for a, b, n in self.device_ops
                   if match in n and self.lo <= a <= self.hi)

    def _under(self, items, t):
        """The innermost (latest-starting) of items (sorted (start, end,
        name)) that is under way at t, or None."""
        i = bisect.bisect_right(items, (t, float("inf"), ""))
        for a, b, n in reversed(items[max(0, i - 64):i]):
            if a <= t <= b:
                return n
        return None

    def breakdown(self, top=10):
        ops = collections.defaultdict(float)
        for a, b, n in self.device_ops:
            if self.lo <= a <= self.hi:
                ops[_short(n)] += b - a
        idle = collections.defaultdict(float)
        for a, b in stats.gaps([(a, b) for a, b, _ in self.device_ops],
                               self.lo, self.hi):
            span = self._under(self.spans, a) or "none"
            op = self._under(self.host, a) or "none"
            idle[f"{span}/{_short(op)}"] += b - a
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in order],
                "idle_gaps": [[n, s] for n, s in gaps]}


def profile(fn):
    """Run fn() under the profiler (host and device activity, no shapes or
    stacks) -> Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        fn()
    return Trace(prof)
