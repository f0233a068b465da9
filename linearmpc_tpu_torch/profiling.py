"""Observability: solve counters, the kernels' work and bounds, stream
overlap, profiler traces, and the program's own spans and counters.

Port of ``linearmpc_tpu/profiling.py``. ``instrument`` wraps an engine's
``solve_batch`` with counters (``SolveStats``), synchronizing the engine's
device where the JAX package blocks on the result. The operation and byte
models count what the port's kernels compute (K1 ``csrc/bulk.cu``, K2
``csrc/polish.cu``, K3 ``csrc/iu.cu`` and its search entry
``csrc/inc_search.cu``, K4 ``csrc/ciu.cu``), not the TPU kernels' one-hot
gathers: they are the one definition of the bounds that ``chip_smoke.py``
reports (``bound``, ``gi_bound``, ``k1_bound``, ``k2_bound``,
``step_bound``, ``search_bound``). The peaks are the H100 SXM's (NVIDIA's
data sheet, at its 700 W limit): HBM3 at 3.35 TB/s, float32 at 67 TFLOP/s
outside the tensor cores and float64 at 67 TFLOP/s on them, the card's
highest rate for each type. ``overlap_report`` times K1 on one batch
against K2 on another on two CUDA streams; ``trace`` records a
``torch.profiler`` trace and writes it in Chrome's format, with the
program's spans beside the profiler's events.

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

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


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


# -- the kernels' work: operations per lane (and iteration) ------------------


def phase1_flops_per_lane_iter(m: int) -> float:
    """K1, one iteration of a lane: the working-set solve with the gathered
    subset inverse and the slack G @ lam (2 m^2 each) and O(m) tests."""
    return 4.0 * m * m + 10.0 * m


def polish_flops_per_lane(m: int, n_u: int, nth: int) -> float:
    """K2, once a lane (native float64): the transformed bounds (m x nth),
    the working-set solve and the slacks (2 m^2), the control (n_u x nth,
    n_u x m), the objective (n_u^2, n_u x nth) and the KKT residual."""
    return 2.0 * (m * nth + 2 * m * m + 2 * n_u * nth + n_u * m + n_u * n_u + 2 * n_u)


def gi_flops_per_lane_iter(m: int, s: int, w) -> float:
    """K3 (s = m) and K4 (s slots), one iteration of a lane whose working set
    holds w rows: the jump, the Goldfarb-Idnani direction and the Woodbury
    product on the inverse (s x w each), the slack G @ lam_base (m x w) and
    the rank-2 update (w^2). ``w`` may be a tensor of per-lane sizes."""
    return 2 * (3 * s * w + m * w) + 4 * w * w


def search_management_flops(m: int, n: int):
    """K3's search entry, one management step of a lane (at most m
    multipliers nonzero): c = G lam (2 m^2), U = U0 - HinvET lam (2 n m),
    HU and fval (2 n^2 + 4 n), the dual bound (4 m) and the fractionality
    of each row (5 m)."""
    return 2.0 * m * m + 2.0 * n * m + 2.0 * n * n + 4.0 * n + 9.0 * m


def iu_flops_per_lane_iter(m: int, w: int | None = None) -> float:
    """K3 at a working set of w rows (all m rows if not given)."""
    return gi_flops_per_lane_iter(m, m, m if w is None else w)


def ciu_flops_per_lane_iter(m: int, s: int, w: int | None = None) -> float:
    """K4 over s slots at a working set of w rows (all slots if not given)."""
    return gi_flops_per_lane_iter(m, s, s if w is None else w)


def phase1_bytes_per_lane(m: int, itemsize: int = 4) -> float:
    """K1's device-memory bytes a lane, each read or written once: the
    bounds, lam in and out (4 m values), act and side in and out (4 m
    bytes), iters and done. The subset table is shared by the batch."""
    return 4.0 * m * itemsize + 4.0 * m + 5.0


def iu_bytes_per_lane(m: int, itemsize: int = 4) -> float:
    """K3's device-memory bytes a lane, each read or written once: the
    bounds and lam in and out (4 m values), the masks in and out (4 m
    bytes), the flags and the count, and the carried (m, m) inverse in and
    out. The inverse stays on the chip between iterations."""
    return 4.0 * m * itemsize + 4.0 * m + 7.0 + 2.0 * m * m * itemsize


def ciu_bytes_per_lane(m: int, s: int, itemsize: int = 4) -> float:
    """K4's device-memory bytes a lane: as ``iu_bytes_per_lane`` with an
    (s, s) slot inverse, and the slot map in and out as int32."""
    return 4.0 * m * itemsize + 4.0 * m + 8.0 + 2.0 * s * s * itemsize + 8.0 * s


# -- bounds: the least time the card could take for a launch's work ----------


def nbytes(*tensors) -> int:
    """Bytes the tensors hold, each read or written once (a broadcast view
    counts the one matrix it views)."""
    return sum(min(t.numel() * t.element_size(), t.untyped_storage().nbytes())
               for t in tensors if isinstance(t, torch.Tensor))


def bound(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    """(least ms, what sets it) for moving n_bytes and doing flops."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def gi_bound(args, out) -> tuple[float, str]:
    """K3/K4's bound on this run's data (``phase1_iu`` / ``phase1_ciu``
    arguments and outputs): inputs and outputs once, and per lane-iteration
    ``gi_flops_per_lane_iter`` at the lane's working set at exit. The slot
    maps, int64 at the wrapper, move as int32 in the kernel."""
    m, s = args[2].shape[1], args[-1].shape[-1]
    w = out[1].sum(1).double()
    flops = float((out[3].double() * gi_flops_per_lane_iter(m, s, w)).sum())
    moved = sum(nbytes(t) // (2 if t.dtype == torch.int64 else 1)
                for t in (*args, *out) if isinstance(t, torch.Tensor))
    return bound(moved, flops, args[2].dtype)


def k1_bound(args, out) -> tuple[float, str]:
    """K1's bound on this run's data (``bulk.phase1`` arguments and
    outputs): inputs and outputs once, ``phase1_flops_per_lane_iter`` for
    each iteration a lane ran."""
    m = args[2].shape[1]
    flops = float(out[3].double().sum()) * phase1_flops_per_lane_iter(m)
    return bound(nbytes(*args) + nbytes(*out), flops, args[2].dtype)


def k2_bound(pd, args, out) -> tuple[float, str]:
    """K2's bound (``polish.polish`` arguments and outputs): the statics,
    theta, the masks and the outputs once, ``polish_flops_per_lane`` a
    lane."""
    B, m = args[2].shape
    n_u, nth = pd.Uth_off.shape
    flops = B * polish_flops_per_lane(m, n_u, nth)
    return bound(nbytes(pd.subset, pd.packed, *args[1:]) + nbytes(*out), flops, torch.float64)


def step_bound(args, st) -> tuple[float, str]:
    """K3 step's bound on this run's data (``iu.step_iu`` arguments and its
    new state): the inputs (the entry state but its iteration count) and
    the new state once, and per lane-iteration ``gi_flops_per_lane_iter``
    with s = m; pend moves as int32 in the kernel."""
    from .ops import iu

    m = args[2].shape[1]
    w = st.act.sum(1).double()
    flops = float((st.iters.double() * gi_flops_per_lane_iter(m, m, w)).sum())
    entry = [t for f, t in zip(iu.IUState._fields, args[6]) if f != "iters"]
    moved = sum(nbytes(t) // (2 if t.dtype == torch.int64 else 1)
                for t in (*args[:6], *entry, *st))
    return bound(moved, flops, args[2].dtype)


def search_bound(fr, res) -> tuple[float, str]:
    """K3 search entry's bound on this run's data (``IncFrontier.search``
    of ``fr`` returning ``res``): the inputs (G, G_solve, the lanes' bounds
    and theta terms, HinvET, H, the masks) and the outputs once, and per
    lane ``gi_flops_per_lane_iter`` for each GI iteration at the
    incumbent's working set plus ``search_management_flops`` for each
    round it ran. The root snapshot is scratch and stays out."""
    arr, step = fr.arr, fr.stepper
    m, n = arr.G.shape[0], arr.HinvET.shape[0]
    w = res.inc_active.sum(1).double()
    flops = float((res.iters.double() * gi_flops_per_lane_iter(m, m, w)).sum()
                  + res.rounds.double().sum() * search_management_flops(m, n))
    moved = nbytes(step.G, step.Gs, step.immut, fr.du_t, fr.dl_t, arr.is_eq, arr.up_finite,
                   arr.lo_finite, fr.branchable_rows, arr.HinvET, arr.H, fr.U0, fr.f_t, *res)
    return bound(moved, flops, torch.float32)


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
