"""The traced run: the device's intervals from ``torch.profiler`` and the
benchmark's own spans around each call, and what they add up to.

The profiler records the device only (``ProfilerActivity.CUDA``: kernels,
copies, sets), and its events are read from the profiler's raw results,
not from a 30-second chrome trace. Its timestamps are Unix nanoseconds;
the spans are ``perf_counter_ns`` moved onto that clock by one offset
taken as the window starts.

The union of intervals and the idle share follow ``chip_smoke.py:2711``
(``idle_share``: the union of the device's kernel and copy intervals over
the wall time), frozen here.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np


def clock_offset() -> int:
    """``time_ns() - perf_counter_ns()``, the tightest of a few reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


class Profiler:
    """``torch.profiler`` over the device alone (on a CPU device, which
    only tests use, over its operators)."""

    def __init__(self, dev):
        from torch.profiler import ProfilerActivity, profile
        self.kind = "CUDA" if dev.type == "cuda" else "CPU"
        self.prof = profile(activities=[getattr(ProfilerActivity,
                                                self.kind)])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def events(self) -> list[tuple[str, int, int]]:
        """``(name, start_ns, end_ns)`` of every device event."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith(self.kind):
                s = int(e.start_ns())
                out.append((e.name(), s, s + int(e.duration_ns())))
        out.sort(key=lambda x: x[1])
        return out


def union(events: list) -> list[tuple[int, int]]:
    """Disjoint busy intervals of the device, in order."""
    merged: list[list[int]] = []
    for _, a, b in events:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


@dataclasses.dataclass
class Timeline:
    """Device events and busy intervals of a traced window, with the
    window's calls on the same clock."""

    events: list             # (name, start, end), by start
    busy: list               # union(events)
    calls: list              # runbook.Call, perf_counter_ns
    offset: int              # add to perf_counter_ns for the events' clock
    t0: int                  # the window, perf_counter_ns
    t1: int

    def __post_init__(self):
        self._bstart = [a for a, _ in self.busy]
        self._cum = np.concatenate([[0], np.cumsum(
            [b - a for a, b in self.busy])]).astype(np.int64)
        self._estart = [e[1] for e in self.events]

    def busy_ns(self, a: int, b: int) -> int:
        """Device-busy nanoseconds inside ``[a, b]`` (perf_counter_ns)."""
        a, b = a + self.offset, b + self.offset
        if b <= a:
            return 0
        i = bisect.bisect_right(self._bstart, a) - 1
        j = bisect.bisect_left(self._bstart, b)
        lo = max(i, 0)
        total = int(self._cum[j] - self._cum[lo])
        if i >= 0:                 # clip the interval holding a
            s, e = self.busy[i]
            total -= min(e, a) - s if a > s else 0
        if j - 1 >= lo:            # clip the last interval at b
            s, e = self.busy[j - 1]
            if e > b:
                total -= e - max(b, s)
        return max(total, 0)

    def events_in(self, a: int, b: int) -> list:
        """Device events that start inside ``[a, b]`` (perf_counter_ns)."""
        a, b = a + self.offset, b + self.offset
        i = bisect.bisect_left(self._estart, a)
        j = bisect.bisect_right(self._estart, b)
        return self.events[i:j]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns(self.t0, self.t1) / 1e9

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the device's
        idle time by what the host was doing: inside a benchmark span
        (``search``, ``copy``: the search's results to the host, ``add``,
        ``remove``) or between calls (``client``)."""
        a, b = self.t0 + self.offset, self.t1 + self.offset
        by_name: dict[str, int] = {}
        for name, s, e in self.events:
            if s >= a and s <= b:
                by_name[name] = by_name.get(name, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:n]
        idle: dict[str, int] = {}
        prev = self.t0

        def add(kind, s, e):
            idle[kind] = idle.get(kind, 0) + (e - s) - self.busy_ns(s, e)

        for c in self.calls:
            add("client", prev, c.t0)
            if c.kind == "search":
                add("search", c.t0, c.t_ret)
                add("copy", c.t_ret, c.t1)
            else:
                add(c.kind, c.t0, c.t1)
            prev = c.t1
        add("client", prev, self.t1)
        gaps = sorted(idle.items(), key=lambda x: -x[1])[:n]
        return {"device_ops": [[k[:200], v / 1e9] for k, v in ops],
                "idle_gaps": [[k, v / 1e9] for k, v in gaps]}
