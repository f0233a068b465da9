"""Trace reading: the profiler's device timeline, the benchmark's own
spans, and the union of device intervals.

The busy time is the union of the profiler's device intervals (kernels,
copies and fills), where ``chip_smoke.device_profile`` summed the
kernels' device time: overlapping kernels count once. Spans are ``record_function``
ranges opened by the benchmark's drivers around calls into the program
(``mpcbench.unit`` around one unit of work, ``mpcbench.call`` around the
program call inside it); the profiler puts them and the device's
intervals on one clock.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

UNIT = "mpcbench.unit"
CALL = "mpcbench.call"


@dataclass
class Interval:
    name: str
    start: float   # seconds on the profiler's clock
    end: float
    kernel: bool = True


@dataclass
class Trace:
    """What a traced window left: device intervals, host operations and
    the benchmark's spans, in seconds on one clock."""

    device: list = field(default_factory=list)     # Interval, sorted by start
    host: list = field(default_factory=list)       # Interval of host operations
    units: list = field(default_factory=list)      # Interval of each unit span
    calls: list = field(default_factory=list)      # Interval of each call span

    @property
    def window(self) -> tuple[float, float]:
        return self.units[0].start, self.units[-1].end

    def kernels(self, match=None, lo=None, hi=None):
        """Kernel intervals (optionally whose name ``match`` accepts) that
        start inside [lo, hi)."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return [d for d in self.device if d.kernel and lo <= d.start < hi
                and (match is None or match(d.name))]


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that at least one interval covers."""
    spans = sorted((max(i.start, lo), min(i.end, hi)) for i in intervals)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_seconds(tr: Trace, lo: float | None = None, hi: float | None = None) -> float:
    lo = tr.window[0] if lo is None else lo
    hi = tr.window[1] if hi is None else hi
    return union_seconds([d for d in tr.device if d.end > lo and d.start < hi], lo, hi)


def _events(prof):
    """(name, is_device, is_kernel, start_s, end_s) of every profiler event."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
        dev = e.device_type() == DeviceType.CUDA
        name = e.name()
        kernel = dev and not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))
        out.append((name, dev, kernel, s, s + d))
    return out


def from_profiler(prof) -> Trace:
    tr = Trace()
    for name, dev, kernel, s, e in _events(prof):
        if dev and name.startswith("mpcbench."):
            continue  # the profiler's device-side copy of a benchmark span
        if dev:
            tr.device.append(Interval(name, s, e, kernel))
        elif name == UNIT:
            tr.units.append(Interval(name, s, e, False))
        elif name == CALL:
            tr.calls.append(Interval(name, s, e, False))
        else:
            tr.host.append(Interval(name, s, e, False))
    for lst in (tr.device, tr.host, tr.units, tr.calls):
        lst.sort(key=lambda i: i.start)
    if not tr.units:
        raise RuntimeError("the profiler recorded none of the benchmark's unit spans")
    return tr


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled by the innermost host operation open at the gap's
    middle (or 'host' when none is)."""
    lo, hi = tr.window
    per = {}
    for d in tr.device:
        if d.end > lo and d.start < hi:
            per[d.name] = per.get(d.name, 0.0) + (min(d.end, hi) - max(d.start, lo))
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]

    gaps = []
    cur = lo
    for d in tr.device:
        if d.end <= lo or d.start >= hi:
            continue
        if d.start > cur:
            gaps.append((cur, d.start))
        cur = max(cur, d.end)
    if hi > cur:
        gaps.append((cur, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = [h.start for h in tr.host]
    labelled = []
    for g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        label = "host"
        j = bisect.bisect_right(starts, mid)
        best = None
        for h in reversed(tr.host[max(0, j - 400):j]):
            if h.end >= mid and (best is None or h.start > best.start):
                best = h
        if best is not None:
            label = best.name
        labelled.append([label[:120], g1 - g0])
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": labelled}
