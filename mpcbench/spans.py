"""What the readers of the program's own spans and counters share.

During a traced window the program keeps its spans and counters in
``linearmpc_tpu_torch.profiling`` (``spans()``, ``counts()``,
``counted(name)``): a span's start and end are ``time.time_ns()``, the
clock of the profiler's host events, so they sit on the timeline of
``Context.trace`` in seconds. A program without that store (a checkout
older than it) gives no spans and no counts, nor does a window without a
device timeline (a run on the CPU): every reader of them then returns
None.

The helpers: the program's spans by name, a span's self time, the
device-idle time inside a span, the window's idle time attributed to the
innermost span open at each moment (or to no span: ``OUTSIDE``), and the
host events inside a span, such as the CUDA runtime's synchronizing calls.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from mpcbench.trace import union_seconds

OUTSIDE = "outside the program"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


@dataclass
class ProgramSpan:
    name: str
    start: float    # seconds on the profiler's clock
    end: float
    parent: int     # index of the enclosing span, -1 for none
    call: int       # index of the outermost span around it
    index: int


def _store(ctx, what: str):
    if not ctx.trace.device:
        return None
    return getattr(getattr(ctx.L, "profiling", None), what, None)


def program_spans(ctx) -> list[ProgramSpan]:
    """The closed spans the program recorded in the window, in the order
    they opened."""
    read = _store(ctx, "spans")
    if read is None:
        return []
    return [ProgramSpan(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9, s.parent, s.call, i)
            for i, s in enumerate(read()) if s.end_ns is not None]


def named(spans, name: str) -> list[ProgramSpan]:
    return [s for s in spans if s.name == name]


def program_counts(ctx) -> dict:
    """The totals of the program's counters in the window."""
    read = _store(ctx, "counts")
    return read() if read is not None else {}


def program_counted(ctx, name: str) -> list:
    """Each value the program counted under ``name`` in the window."""
    read = _store(ctx, "counted")
    return read(name) if read is not None else []


def children(spans) -> dict:
    """index -> the spans whose parent it is."""
    out: dict = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def self_seconds(sp, kids, only=None) -> float:
    """Seconds of ``sp`` that its children ``kids`` (those named in
    ``only``, where given) do not cover."""
    kids = [k for k in kids if only is None or k.name in only]
    return (sp.end - sp.start) - union_seconds(kids, sp.start, sp.end)


class Busy:
    """The device-busy time of a trace as disjoint intervals: the busy
    seconds inside any [lo, hi] in log time."""

    def __init__(self, trace):
        merged = []
        for d in sorted(trace.device, key=lambda d: d.start):
            if merged and d.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], d.end)
            elif d.end > d.start:
                merged.append([d.start, d.end])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.cum = [0.0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + (e - s))

    def seconds(self, lo: float, hi: float) -> float:
        i = bisect.bisect_right(self.ends, lo)
        j = bisect.bisect_left(self.starts, hi)
        if i >= j:
            return 0.0
        total = self.cum[j] - self.cum[i]
        total -= max(0.0, lo - self.starts[i]) + max(0.0, self.ends[j - 1] - hi)
        return total

    def idle(self, lo: float, hi: float) -> float:
        return max(0.0, (hi - lo) - self.seconds(lo, hi))


def idle_inside(ctx, spans) -> float | None:
    """Device-idle seconds inside the spans (outermost among themselves),
    or None where the window has no device timeline or no such span."""
    if not ctx.trace.device or not spans:
        return None
    busy = Busy(ctx.trace)
    return sum(busy.idle(s.start, s.end) for s in spans)


def self_pieces(spans):
    """(start, end, span) of each stretch of time in which ``span`` is the
    innermost open span, sorted by start."""
    kids = children(spans)
    out = []
    for s in spans:
        t = s.start
        for k in sorted(kids.get(s.index, []), key=lambda k: k.start):
            if k.start > t:
                out.append((t, k.start, s))
            t = max(t, k.end)
        if s.end > t:
            out.append((t, s.end, s))
    out.sort(key=lambda p: p[0])
    return out


def idle_by_innermost(ctx) -> dict:
    """The window's device-idle seconds by the innermost program span open
    at each moment; ``OUTSIDE`` holds the idle time in no span. The values
    sum to the window's idle time."""
    lo, hi = ctx.trace.window
    busy = Busy(ctx.trace)
    out: dict = {}
    inside = 0.0
    for a, b, s in self_pieces(program_spans(ctx)):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            idle = busy.idle(a, b)
            out[s.name] = out.get(s.name, 0.0) + idle
            inside += idle
    out[OUTSIDE] = busy.idle(lo, hi) - inside
    return out


def host_by_innermost(ctx, match) -> dict:
    """How many host events that ``match`` accepts start in each innermost
    program span (``OUTSIDE`` where none is open), inside the window."""
    lo, hi = ctx.trace.window
    pieces = self_pieces(program_spans(ctx))
    starts = [p[0] for p in pieces]
    out: dict = {}
    for h in ctx.trace.host:
        if not (lo <= h.start < hi and match(h.name)):
            continue
        j = bisect.bisect_right(starts, h.start) - 1
        name = pieces[j][2].name if j >= 0 and h.start < pieces[j][1] else OUTSIDE
        out[name] = out.get(name, 0) + 1
    return out


def is_sync(name: str) -> bool:
    """A CUDA-runtime call that waits for the device: a stream or device
    synchronize, or a synchronous (not ``Async``) ``cudaMemcpy*``."""
    return name in SYNCS or (name.startswith("cudaMemcpy") and not name.endswith("Async"))


def host_events_inside(ctx, spans, match) -> int:
    """Host events that ``match`` accepts starting inside any of the spans
    (spans that do not overlap)."""
    host = ctx.trace.host
    starts = [h.start for h in host]
    n = 0
    for sp in spans:
        i, j = bisect.bisect_left(starts, sp.start), bisect.bisect_left(starts, sp.end)
        n += sum(1 for h in host[i:j] if match(h.name))
    return n
