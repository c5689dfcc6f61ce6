"""The profiler over a measured window, read into plain numbers.

With ``--trace 1`` the window runs under ``torch.profiler`` on every
thread of the process (the server's request threads, the batcher's worker
and the training feed). The raw events are read once, straight from the
profiler's results (the event tree of ``key_averages()`` takes minutes at
tens of thousands of launches): the device's kernels, copies and sets,
and the harness's own ``record_function`` ranges, named ``port_bench.*``.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    correlation: int


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float                 # union of the device's op intervals
    ops: list                     # DeviceOp, in start order
    ranges: dict                  # annotation -> [(start_ns, end_ns)] on
                                  # the device's timeline
    launches_in: dict             # annotation -> correlation ids launched
                                  # inside its host ranges
    host_ranges: list             # the harness's ranges on the host:
                                  # (name, tid, start_ns, end_ns)
    host_ops: list                # aten ops on the host, the same way
    window_ns: tuple              # (start, end) on the profiler's clock

    def device_s_in(self, annotation: str) -> Optional[float]:
        """Device seconds of the ops launched inside the harness's range
        ``annotation``, or None where it was never entered."""
        ids = self.launches_in.get(annotation)
        if ids:
            return sum(o.dur_ns for o in self.ops
                       if o.correlation in ids) / 1e9
        spans = self.ranges.get(annotation)
        if not spans:
            return None
        total = 0
        for o in self.ops:
            mid = o.start_ns + o.dur_ns // 2
            if any(a <= mid < b for a, b in spans):
                total += o.dur_ns
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, summed by name, and the
        longest idle gaps of the device, each named by the harness range
        or host op running on the host when it began."""
        by_name = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0) + o.dur_ns
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.window_ns[0]
        for o in self.ops:
            if o.start_ns > end:
                gaps.append((o.start_ns - end, end))
            end = max(end, o.start_ns + o.dur_ns)
        if self.window_ns[1] > end:
            gaps.append((self.window_ns[1] - end, end))
        gaps.sort(reverse=True)
        named = []
        for dur, at in gaps[:top]:
            named.append([self._host_at(at), dur / 1e9])
        return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
                "idle_gaps": named}

    def _host_at(self, t_ns: int) -> str:
        """The innermost harness range and aten op running on the host at
        ``t_ns`` (the latest to start of each)."""
        def inner(ranges):
            best = None
            for name, _, a, b in ranges:
                if a <= t_ns < b and (best is None or a > best[0]):
                    best = (a, name)
            return best[1] if best else None
        names = [n for n in (inner(self.host_ranges), inner(self.host_ops))
                 if n]
        return " / ".join(names)[:120] if names else "host (no range)"


class Window:
    """``with Window(trace) as w:`` around the measured work; ``w.summary``
    is a TraceSummary after it when ``trace`` is on."""

    def __init__(self, trace: bool, attribute=()):
        self.trace = trace
        self.attribute = attribute
        self.summary: Optional[TraceSummary] = None
        self._prof = None

    def __enter__(self):
        if self.trace:
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
            self._prof.__enter__()
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.time()
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(self._prof, self.t1 - self.t0,
                                         self.attribute)
        return False


def summarize(prof, window_s: float, attribute=()) -> TraceSummary:
    """The trace's device ops, busy time and ranges; for each harness
    range named in ``attribute``, the correlation ids of the device work
    launched inside it."""
    from torch.autograd import DeviceType
    ops, dev_ranges, host_ranges, launches = [], {}, [], []
    host_ops = []
    lo, hi = None, None
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                if e.name().startswith("port_bench."):
                    dev_ranges.setdefault(e.name(), []).append(
                        (start, start + dur))
                continue
            ops.append(DeviceOp(e.name(), start, dur, e.correlation_id()))
            continue
        lo = start if lo is None else min(lo, start)
        hi = start + dur if hi is None else max(hi, start + dur)
        name = e.name()
        if e.is_user_annotation() and name.startswith("port_bench."):
            host_ranges.append((name, e.start_thread_id(), start,
                                start + dur))
        elif name.startswith("aten::"):
            host_ops.append((name, 0, start, start + dur))
        if name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                            "cudaMemset", "cudaGraphLaunch")):
            launches.append((e.start_thread_id(), start, e.correlation_id()))
    ops.sort(key=lambda o: o.start_ns)
    launches_in = {}
    for name in attribute:
        # a harness range does not nest in itself: per thread, the last
        # range that starts at or before a launch is the only candidate
        per_tid = {}
        for n, tid, a, b in host_ranges:
            if n == name:
                per_tid.setdefault(tid, []).append((a, b))
        for spans in per_tid.values():
            spans.sort()
        starts = {tid: [a for a, _ in spans]
                  for tid, spans in per_tid.items()}
        ids = set()
        for tid, t, corr in launches:
            spans = per_tid.get(tid)
            if not spans:
                continue
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and t < spans[i][1]:
                ids.add(corr)
        launches_in[name] = ids
    busy, end = 0, None
    for o in ops:
        s, f = o.start_ns, o.start_ns + o.dur_ns
        if end is None or s >= end:
            busy += f - s
            end = f
        elif f > end:
            busy += f - end
            end = f
    if ops:
        lo = min(lo or ops[0].start_ns, ops[0].start_ns)
        hi = max(hi or 0, max(o.start_ns + o.dur_ns for o in ops))
    return TraceSummary(window_s=window_s, busy_s=busy / 1e9, ops=ops,
                        ranges=dev_ranges, launches_in=launches_in,
                        host_ranges=host_ranges, host_ops=host_ops,
                        window_ns=(lo or 0, hi or 0))
