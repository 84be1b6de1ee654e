"""The device trace of a traced run (``torch.profiler``, CUDA activity):
busy seconds (the union of every kernel, copy and set on the card), the
kernels that took most time, and the idle gaps attributed to the
benchmark's host spans (``probes.Spans``). A marker launched at a known
host time aligns the two clocks."""
from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_start = self.t_stop = None
        self.events: List[Tuple[str, int, int]] = []
        self.offset_ns: Optional[float] = None

    def open(self):
        """Start the profiler (seconds: set-up's, not the window's)."""
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def start(self):
        torch.cuda.synchronize(self.device)
        self.t_start = time.perf_counter()
        torch.ones(1, device=self.device).mul_(3.0)     # the marker
        torch.cuda.synchronize(self.device)

    def stop(self):
        torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        try:
            raw = self.prof.profiler.kineto_results.events()
            ev = [(e.name(), int(e.start_ns()), int(e.duration_ns()))
                  for e in raw if e.device_type() == cuda]
        except AttributeError:
            ev = [(e.name, int(e.time_range.start * 1000),
                   int(e.time_range.elapsed_us() * 1000))
                  for e in self.prof.events() if e.device_type == cuda]
        ev.sort(key=lambda x: x[1])
        self.prof = None
        self.events = ev
        if ev:
            # the first device event is the marker, launched right after
            # t_start with the queue empty
            self.offset_ns = ev[0][1] - self.t_start * 1e9

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _n, s, d in self.events:
            e = s + d
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_seconds(self, match) -> Tuple[float, int]:
        tot, n = 0, 0
        for name, _s, d in self.events:
            if match(name):
                tot += d
                n += 1
        return tot / 1e9, n

    def top_ops(self, n: int = 10) -> List[list]:
        c: Counter = Counter()
        for name, _s, d in self.events:
            c[name] += d
        return [[k[:160], v / 1e9] for k, v in c.most_common(n)]

    def idle_gaps(self, spans, n: int = 10) -> List[list]:
        """Idle time of the card inside the window, by the innermost host
        span open at each gap's midpoint (``harness`` where none is)."""
        if self.offset_ns is None:
            return []
        busy = self.busy_intervals()
        lo = self.t_start * 1e9 + self.offset_ns
        hi = self.t_stop * 1e9 + self.offset_ns
        gaps = []
        prev = lo
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        sp = sorted(((s0 * 1e9 + self.offset_ns, s1 * 1e9 + self.offset_ns,
                      depth, name) for name, s0, s1, depth in spans))
        c: Counter = Counter()
        j = 0
        open_: List[tuple] = []
        for a, b in gaps:
            mid = (a + b) / 2
            while j < len(sp) and sp[j][0] <= mid:
                open_.append(sp[j])
                j += 1
            open_ = [s for s in open_ if s[1] >= mid]
            name = max(open_, key=lambda s: s[2])[3] if open_ else "harness"
            c[name] += (b - a) / 1e9
        return [[k, v] for k, v in c.most_common(n)]
