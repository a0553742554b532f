"""Reading a traced window: each device operation given to the harness
range in which the host launched it, the device's busy share, and where it
stood idle.

Ranges, not kernel names: the harness wraps named functions of the program
in ``torch.profiler.record_function`` ranges (``harness/ranges.py``), and a
device operation belongs to the innermost such range open on the launching
thread when its launch ran (matched by the profiler's correlation id). A
later change that renames or replaces a kernel keeps its time in the range.

The busy share is the arithmetic of ``chip_smoke.py:5603-5660``
(``profile_phase``: the device's busy time over the profiled window), taken
from the chrome trace's timeline: the union of the device operations'
intervals inside the window, so two streams that overlap count once. The
window runs from the start of the first recorded profiler step to the end
of the last; each step is one call, which ends with its results on the
host.
"""
from __future__ import annotations

import bisect
import collections
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP = re.compile(r"ProfilerStep#(\d+)$")
NO_RANGE = "outside the harness's ranges"
BETWEEN = "between calls"
TOP = 10


class _Intervals:
    """CPU intervals of one thread, for 'innermost containing t'."""

    def __init__(self, items):
        self.items = sorted(items)            # (start, end, label)
        self.starts = [s for s, _, _ in self.items]

    def innermost(self, t):
        i = bisect.bisect_right(self.starts, t)
        best = None
        for s, e, label in reversed(self.items[max(0, i - 64):i]):
            if s <= t <= e and (best is None or s > best[0]):
                best = (s, label)
        return None if best is None else best[1]


class TraceView:
    """The device operations of a chrome trace, each with its range."""

    def __init__(self, trace: dict, labels):
        labels = set(labels)
        events = trace["traceEvents"]
        ranges, steps, launches, ops = {}, {}, {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat"), e.get("name", "")
            if cat == "user_annotation":
                m = STEP.match(name)
                iv = (e["ts"], e["ts"] + e["dur"])
                if m:
                    steps.setdefault(e["tid"], []).append(
                        (*iv, int(m.group(1))))
                elif name in labels:
                    ranges.setdefault(e["tid"], []).append((*iv, name))
            elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (e["ts"], e["tid"])
            elif cat in DEVICE_CATS:
                ops.append(e)
        self.ranges = {t: _Intervals(v) for t, v in ranges.items()}
        self.steps = {t: _Intervals(v) for t, v in steps.items()}
        spans = [iv for v in steps.values() for iv in v]
        self.calls = len(spans)
        self.window = ((min(s for s, _, _ in spans), max(e for _, e, _ in spans))
                       if spans else (0.0, 0.0))
        self.ops = []                         # (start, end, name, label, step)
        for e in ops:
            launch = launches.get(e.get("args", {}).get("correlation"))
            label, step = NO_RANGE, None
            if launch is not None:
                t, tid = launch
                if tid in self.ranges:
                    label = self.ranges[tid].innermost(t) or NO_RANGE
                if tid in self.steps:
                    step = self.steps[tid].innermost(t)
            self.ops.append((e["ts"], e["ts"] + e["dur"], e["name"], label,
                             step))
        self.ops.sort()

    def _in_window(self):
        w0, w1 = self.window
        for s, e, name, label, step in self.ops:
            if s < w1 and e > w0:
                yield max(s, w0), min(e, w1), name, label, step

    # -- readings -------------------------------------------------------------
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, inside the window."""
        busy, end = 0.0, None
        for s, e, *_ in self._in_window():
            if e <= s:
                continue
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e6

    def device_ms_per_call(self, labels) -> float | None:
        """Device ms a call of the operations launched inside ``labels``;
        None when no call was traced or none ran there."""
        labels = set(labels)
        total = sum(e - s for s, e, _, label, step in self.ops
                    if label in labels and step is not None)
        if not self.calls or total <= 0:
            return None
        return total / 1e3 / self.calls

    def breakdown(self) -> dict:
        """The device operations that took most time in the window, named
        ``range | kernel``, and the idle time by what the host was doing:
        the range in which it launched the operation that ended the gap,
        or 'between calls' when that operation belongs to the next call."""
        by_op = collections.Counter()
        for s, e, name, label, step in self._in_window():
            by_op[f"{label} | {name[:80]}"] += (e - s) / 1e6
        idle = collections.Counter()
        end, end_step = self.window[0], None
        for s, e, name, label, step in self._in_window():
            if s > end:
                why = BETWEEN if (end_step is not None and step is not None
                                  and step != end_step) else label
                idle[why] += (s - end) / 1e6
            if e > end:
                end, end_step = e, step
        if self.window[1] > end:
            idle["after the last operation"] += (self.window[1] - end) / 1e6
        return {"device_ops": [[k, v] for k, v in by_op.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)]}
