"""Observability: solve counters, stream overlap, profiler traces, and the
program's own spans and counters.

Port of ``linearmpc_tpu/profiling.py``. ``instrument`` wraps an engine's
``solve_batch`` with counters (``SolveStats``), synchronizing the engine's
device where the JAX package blocks on the result. ``overlap_report`` times
K1 on one batch against K2 on another on two CUDA streams; ``trace``
records a ``torch.profiler`` trace and writes it in Chrome's format, with
the program's spans beside the profiler's events. The benchmark
(``mpcbench/``) reads the spans and counters for its per-layer metrics and
keeps its own work models of the kernels.

**Spans and counters.** The solve paths mark their layer boundaries with
``span("lmpc.<layer>.<stage>")`` and count their work with ``count(name,
value)``. The switch is a ``torch.profiler`` session: while none records,
a span or a count costs one check of the profiler's flag and stores
nothing (it only marks the store as read); while one records, spans and
counts go to one store in memory, which empties at the first record of
the next session. Spans nest by the order they open, so the store serves
one thread calling the program at a time. A span keeps
``time.time_ns()`` at its start and end, the clock of the profiler's own
host events, so spans, host events and device intervals share one time
base; it enters no ``record_function``, launches nothing and reads nothing
from the device. A count of a device tensor holds the tensor and reduces
it only when ``counts`` or ``counted`` is read, after the session.
``spans()`` returns the records, ``counts()`` the totals.

Every measurement here runs on the engine's device; ``overlap_report``
needs the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch


@dataclass
class SolveStats:
    n_calls: int = 0
    n_solves: int = 0
    n_converged: int = 0
    total_iters: int = 0
    max_iters: int = 0
    total_time_s: float = 0.0
    batch_times_s: list = field(default_factory=list)

    @property
    def solves_per_s(self) -> float:
        return self.n_solves / self.total_time_s if self.total_time_s > 0 else 0.0

    @property
    def mean_iters(self) -> float:
        return self.total_iters / self.n_solves if self.n_solves else 0.0

    def p99_batch_latency(self) -> float:
        return float(np.percentile(self.batch_times_s, 99)) if self.batch_times_s else 0.0

    def summary(self) -> dict:
        return {
            "calls": self.n_calls,
            "solves": self.n_solves,
            "converged_frac": self.n_converged / self.n_solves if self.n_solves else 1.0,
            "mean_iters": round(self.mean_iters, 3),
            "max_iters": self.max_iters,
            "solves_per_s": round(self.solves_per_s, 1),
            "p99_batch_latency_s": self.p99_batch_latency(),
        }


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def instrument(engine) -> SolveStats:
    """Wrap ``engine.solve_batch`` with counters; returns the live stats
    object (also stored as ``engine.stats``). Each call's time ends in a
    synchronize of the engine's device."""
    stats = SolveStats()
    inner = engine.solve_batch

    def wrapped(thetas, warm=None):
        t0 = time.perf_counter()
        sol = inner(thetas, warm=warm)
        _sync(engine.device)
        dt = time.perf_counter() - t0
        st = sol.status.cpu().numpy()
        it = sol.iters.cpu().numpy()
        stats.n_calls += 1
        stats.n_solves += len(st)
        stats.n_converged += int((st == 1).sum())
        stats.total_iters += int(it.sum())
        stats.max_iters = max(stats.max_iters, int(it.max()) if len(it) else 0)
        stats.total_time_s += dt
        stats.batch_times_s.append(dt)
        return sol

    engine.solve_batch = wrapped
    engine.stats = stats
    return stats


# -- the program's spans and counters ----------------------------------------

_recording = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One span of a profiler session. ``parent`` is the index in ``spans()``
    of the span open around it (-1 for none), ``call`` the index of the
    outermost span around it (its own for an outermost span): the spans of
    one call into the program share it."""

    name: str
    start_ns: int        # time.time_ns(), the clock of the profiler's host events
    end_ns: int | None   # None while the span is open
    parent: int
    call: int


class _Store:
    """The spans and counts of one profiler session."""

    def __init__(self):
        self.spans: list[list] = []    # [name, start_ns, end_ns, parent, call]
        self.open: list[int] = []      # indices of the open spans, innermost last
        self.counts: list[list] = []   # [name, value, read]: read once, after the session
        self.stale = True              # the switch was seen off since the last record

    def live(self) -> "_Store":
        """The store a record goes to, emptied first where a session ended."""
        if self.stale:
            self.spans, self.open, self.counts = [], [], []
            self.stale = False
        return self

    def seen(self) -> "_Store":
        """The store as a reader finds it; read between sessions, it empties
        at the next session's first record."""
        if not _recording():
            self.stale = True
        return self


_STORE = _Store()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _STORE.live()
        i = len(st.spans)
        parent = st.open[-1] if st.open else -1
        self.rec = [self.name, 0, None, parent, st.spans[parent][4] if parent >= 0 else i]
        st.spans.append(self.rec)
        st.open.append(i)
        self.rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        st = _STORE
        if st.open and st.spans[st.open[-1]] is self.rec:
            st.open.pop()
        return False


def span(name: str):
    """A context manager marking one stage of the program, recorded while a
    ``torch.profiler`` session records; otherwise a shared no-op."""
    if _recording():
        return _Span(name)
    _STORE.stale = True
    return _OFF


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while a profiler session records:
    a host integer, a device tensor (its sum), or a function of tensors the
    caller already holds returning one of them. Tensors and functions are
    held, and read only by ``counts``/``counted``, after the session: a
    count launches nothing and reads nothing from the device."""
    if _recording():
        _STORE.live().counts.append([name, value, False])
    else:
        _STORE.stale = True


def spans() -> list[Span]:
    """The spans of the last profiler session, in the order they opened."""
    return [Span(*r) for r in _STORE.seen().spans]


def _read(entry):
    if not entry[2]:
        v = entry[1]() if callable(entry[1]) else entry[1]
        entry[1] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        entry[2] = True
    return entry[1]


def counted(name: str) -> list:
    """Each value counted under ``name`` in the last session, in order, on
    the host (a NumPy array for a tensor)."""
    return [_read(e) for e in _STORE.seen().counts if e[0] == name]


def counts() -> dict:
    """The totals of the last session's counters."""
    out: dict = {}
    for e in _STORE.seen().counts:
        v = np.sum(_read(e))
        out[e[0]] = out.get(e[0], 0) + (v.item() if isinstance(v, np.generic) else v)
    return out


def _write_spans(path: str):
    """Add the session's spans to the Chrome trace at ``path`` as complete
    events of this process, on the trace's own time base."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), threading.get_native_id()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "lmpc", "name": sp.name, "pid": pid, "tid": tid,
         "ts": (sp.start_ns - base) / 1e3, "dur": (sp.end_ns - sp.start_ns) / 1e3,
         "args": {"index": i, "parent": sp.parent, "call": sp.call}}
        for i, sp in enumerate(spans()) if sp.end_ns is not None)
    with open(path, "w") as f:
        json.dump(doc, f)


# -- stream overlap of the small-m tier's two kernels -------------------------


def _event_s(fn, reps: int) -> float:
    """Best of three runs of ``reps`` calls, seconds a call, CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / 1e3 / reps)
    return best


def overlap_report(mpc, B: int = 32768, seed: int = 0, reps: int = 4) -> dict:
    """Whether batch k+1's bulk phase (K1) overlaps batch k's polish (K2):
    each timed alone, then the pair with K1 on a second CUDA stream while
    K2 runs on the current one. ``fill_frac`` = 1 - pair / (K1 + K2): the
    share of the serial time the second stream fills. Needs the small-m
    tier of an engine on the card."""
    from .ops import bulk, polish

    engine = mpc.engine
    if engine.device.type != "cuda":
        raise ValueError(f"overlap_report times CUDA streams; the engine is on {engine.device}")
    if engine.path != "small":
        raise ValueError(f"overlap_report takes the small-m tier (K1, K2), not {engine.path!r}")
    dev, arr, m = engine.device, engine.arrays, engine.ldp.m
    rng = np.random.default_rng(seed)
    th_k, th_next = (torch.as_tensor(rng.uniform(-10, 10, (B, engine.ldp.n_theta)), device=dev)
                     for _ in range(2))
    kw = dict(max_iter=engine.bulk_cap, primal_tol=engine.primal_tol, sign_tol=engine.sign_tol)
    cold = (torch.zeros((B, m), dtype=torch.float32, device=dev),
            arr.is_eq.expand(B, m).contiguous(),
            torch.ones((B, m), dtype=torch.bool, device=dev))

    def k1_args(th):
        du_t, dl_t = engine._bounds32(th)
        return (arr.subset_inv, arr.G, du_t.contiguous(), dl_t.contiguous(), engine._eq,
                engine._immut, *cold)

    args_k, args_next = k1_args(th_k), k1_args(th_next)
    _lam, act, side, _it, _done = bulk.phase1(*args_k, **kw)
    side_stream = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)

    def k1():
        bulk.phase1(*args_next, **kw)

    def k2():
        polish.polish(engine._pd, th_k, act, side)

    def pair():
        side_stream.wait_stream(main)
        with torch.cuda.stream(side_stream):
            k1()
        k2()
        main.wait_stream(side_stream)

    t_k1, t_k2, t_pair = _event_s(k1, reps), _event_s(k2, reps), _event_s(pair, reps)
    return {"t_phase1_s": t_k1, "t_polish_s": t_k2, "t_pair_s": t_pair,
            "t_sum_s": t_k1 + t_k2, "fill_frac": 1.0 - t_pair / (t_k1 + t_k2)}


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of the block (the CPU, and the card where
    CUDA is available), written to ``logdir/trace.json`` in Chrome's
    format with the program's spans of the block (``spans()``); yields the
    profiler. ``counts()`` reads the block's counters after it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _STORE.stale = True
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path)
