"""The port's spans and counters (``linearmpc_tpu_torch/profiling.py``):
off without a profiler session, and under one on the CPU the stages of the
IU tier, the branch-and-bound search, the rollout and the single solve,
nested by time with their parent and call, the counters against what the
batch used, the shared clock with the profiler's own events, and the
spans in ``profiling.trace``'s Chrome trace. Two tests, marked ``gpu``,
hold a span around a kernel launch to the kernel's device interval, and
run ``instrument``, ``overlap_report`` and ``trace`` on the card.

The file imports no JAX; on a card:
``python -m pytest --noconftest -m gpu tests/test_torch_tracing.py``.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import linearmpc_tpu_torch as L
from linearmpc_tpu_torch import profiling as P
from linearmpc_tpu_torch.ops import engine as eng
from linearmpc_tpu_torch.ops.bnb_frontier import IncFrontier

IU = ["lmpc.iu.k3", "lmpc.iu.refine", "lmpc.iu.pools", "lmpc.iu.resolve64"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def crazyflie():
    """Crazyflie's problem at its defaults (m = 40, the IU tier), float32."""
    mpc = L.mpc_examples("crazyflie")[0].setup(device="cpu", dtype=torch.float32)
    assert mpc.engine.path == "iu"
    return mpc


@pytest.fixture(scope="module")
def satellite():
    mpc = L.mpc_examples("satellite", 6, 6)[0].setup(device="cpu", dtype=torch.float32)
    assert mpc.engine.bnb_mode == "inc"
    return mpc


def _x(seed, B, n=12):
    return np.random.default_rng(seed).uniform(-1, 1, (B, n))


def _recorded(fn):
    """fn's result and the spans and counts of a CPU profiler session
    around it."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, P.spans(), P.counts()


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _nested(spans):
    """Every span closed, inside its parent's interval, and its call the
    outermost span around it."""
    for i, s in enumerate(spans):
        assert s.end_ns is not None and s.start_ns <= s.end_ns, s
        if s.parent < 0:
            assert s.call == i
        else:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
            assert s.call == p.call


def test_no_session_stores_nothing(crazyflie, satellite):
    """Without a profiler session the solve paths add nothing to the store:
    it still holds the last session's one span, and no count."""
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("lmpc.test"):
            pass
    before = P.spans()
    assert [s.name for s in before] == ["lmpc.test"]
    crazyflie.engine.solve_batch(_x(0, 16))
    L.build_rollout(crazyflie)(_x(1, 4).astype(np.float32), None, None, N=2)
    satellite.solve(satellite.form_parameter([0.1, -0.2, 0.05], r=[0.5, 0, 0]))
    satellite.compute_control([0.1, -0.2, 0.05], r=[0.5, 0, 0])
    P.count("lmpc.test", 1)
    assert P.spans() == before
    assert P.counts() == {}


def test_iu_batch_spans_and_pool_counters(crazyflie, monkeypatch):
    """B = 64: one ``solve_batch`` span with the IU tier's four stages in
    order, nested by time; the re-solve counters equal the pool the batch
    used and the lanes of it that float32 left uncertified."""
    e = crazyflie.engine
    seen = {}
    pools, merge = e._pools, eng.SolverEngine._merge

    def pools_seen(*a):
        seen["idx"] = pools(*a)
        return seen["idx"]

    def merge_seen(out, idx, fix):
        seen["status"] = out.status
        return merge(out, idx, fix)

    monkeypatch.setattr(e, "_pools", pools_seen)
    monkeypatch.setattr(eng.SolverEngine, "_merge", staticmethod(merge_seen))
    sol, spans, counts = _recorded(lambda: e.solve_batch(_x(2, 64)))
    assert bool((sol.status == 1).all())
    assert spans[0].name == "lmpc.engine.solve_batch" and spans[0].parent == -1
    assert [s.name for s in spans[1:]] == IU
    assert all(s.parent == 0 and s.call == 0 for s in spans[1:])
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end_ns <= b.start_ns
    _nested(spans)
    assert counts["iu.resolve_lanes"] == seen["idx"].numel() == 64
    assert counts["iu.resolve_needed"] == int((seen["status"][seen["idx"]] != 1).sum())
    assert P.counted("iu.resolve_lanes") == [64]


def test_bnb_spans_and_counters(satellite, monkeypatch):
    """The satellite's ``IncFrontier.solve`` (plain rounds on the CPU):
    prepare, search and finish with the polish inside it; the node and
    iteration counters are the search's own."""
    seen = {}
    finish = IncFrontier.finish

    def finish_seen(self, s):
        seen["res"] = s
        return finish(self, s)

    monkeypatch.setattr(IncFrontier, "finish", finish_seen)
    th = np.hstack([_x(3, 4, 3), _x(4, 4, 3)])
    sol, spans, counts = _recorded(lambda: satellite.engine.solve_batch(th))
    assert [s.name for s in spans] == ["lmpc.engine.solve_batch", "lmpc.bnb.prepare",
                                       "lmpc.bnb.search", "lmpc.bnb.finish", "lmpc.bnb.polish"]
    assert [s.parent for s in spans] == [-1, 0, 0, 0, 3]
    _nested(spans)
    res = seen["res"]
    assert counts["bnb.nodes"] == int(res.nodes.sum()) and counts["bnb.lanes"] == 4
    assert counts["bnb.iters"] == int(res.iters.sum())
    (iters,) = P.counted("bnb.iters")
    assert np.array_equal(iters, res.iters.numpy())


def test_rollout_spans_each_step(crazyflie):
    """A rollout of N steps: one run span, N step spans, each with theta,
    solve and plant, and the warm K3 step's three stages inside solve."""
    N = 3
    _, spans, counts = _recorded(
        lambda: L.build_rollout(crazyflie)(_x(5, 8).astype(np.float32), None, None, N=N))
    _nested(spans)
    assert spans[0].name == "lmpc.rollout.run" and counts == {}
    steps = _children(spans, 0)
    assert [s.name for s in steps] == ["lmpc.rollout.step"] * N
    for st in steps:
        kids = _children(spans, spans.index(st))
        assert [k.name for k in kids] == ["lmpc.rollout.theta", "lmpc.rollout.solve",
                                          "lmpc.rollout.plant"]
        inner = _children(spans, spans.index(kids[1]))
        assert [k.name for k in inner] == ["lmpc.iu.k3", "lmpc.iu.newton_schulz",
                                           "lmpc.iu.refine"]
    assert len(spans) == 1 + 7 * N


def test_single_solve_spans(satellite):
    """``compute_control``: the parameter, the engine's solve (the batch of
    one through the search, then the reads to the host), one call."""
    _, spans, _ = _recorded(lambda: satellite.compute_control([0.1, -0.2, 0.05],
                                                              r=[0.5, 0, 0]))
    _nested(spans)
    names = [s.name for s in spans]
    assert names == ["lmpc.mpc.control", "lmpc.mpc.parameter", "lmpc.engine.solve",
                     "lmpc.engine.solve_batch", "lmpc.bnb.prepare", "lmpc.bnb.search",
                     "lmpc.bnb.finish", "lmpc.bnb.polish", "lmpc.engine.to_host"]
    assert {s.call for s in spans} == {0}
    solve = names.index("lmpc.engine.solve")
    assert [s.name for s in _children(spans, solve)] == ["lmpc.engine.solve_batch",
                                                         "lmpc.engine.to_host"]


def test_span_brackets_the_profilers_interval():
    """The span's clock is the profiler's: a span brackets the profiler's
    own interval of an aten op run inside it."""
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("lmpc.test.clock"):
            torch.mm(a, a)
    (sp,) = P.spans()
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert sp.start_ns <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() <= sp.end_ns


def test_trace_writes_the_program_spans(tmp_path, crazyflie):
    """``profiling.trace`` adds the block's spans to its Chrome trace, on
    the trace's time base, with their parent and call."""
    with P.trace(str(tmp_path / "tr")):
        crazyflie.engine.solve_batch(_x(6, 16))
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "lmpc"]
    spans = P.spans()
    assert [e["name"] for e in ours] == [s.name for s in spans] == [
        "lmpc.engine.solve_batch", *IU]
    base = doc.get("baseTimeNanoseconds", 0)
    for i, (e, s) in enumerate(zip(ours, spans)):
        assert e["ph"] == "X" and e["args"] == {"index": i, "parent": s.parent, "call": s.call}
        assert e["ts"] == pytest.approx((s.start_ns - base) / 1e3, abs=1e-2)
    (mm,) = [e for e in doc["traceEvents"] if e.get("name") == "lmpc.engine.solve_batch"]
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"
           and mm["ts"] <= e["ts"] <= mm["ts"] + mm["dur"]]
    assert ops and all(e["pid"] == mm["pid"] for e in ops)


@pytest.mark.gpu
def test_span_contains_the_kernels_device_interval():
    """On the card: a span opened before a kernel's launch and closed after
    ``torch.cuda.synchronize()`` contains the kernel's device interval in
    the profiler's trace (CUPTI's clock converted to the host's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(2048, 2048, device="cuda")
    torch.mm(a, a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with P.span("lmpc.test.kernel"):
            torch.mm(a, a)
            torch.cuda.synchronize()
    (sp,) = P.spans()
    from torch.autograd import DeviceType

    dev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    assert dev, "the profiler recorded no device interval"
    for e in dev:
        assert sp.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= sp.end_ns


@pytest.mark.gpu
def test_instrument_overlap_and_trace_on_card(tmp_path):
    """invpend's cold tier through setup() at B = 32768 on the card:
    ``instrument`` counts every lane of four batches converged;
    ``overlap_report`` launches K1 and K2; ``trace`` writes a Chrome trace
    and the batch's spans, the tier's stages in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from linearmpc_tpu_torch.ops import bulk, polish

    mpc = L.mpc_examples("invpend")[0].setup()
    e = mpc.engine
    rng = np.random.default_rng(30)
    th = torch.as_tensor(np.hstack([rng.uniform(-20, 20, (32768, 6)),
                                    rng.uniform(-2, 2, (32768, 1))]), device="cuda")
    stats = L.instrument(e)
    for _ in range(4):
        e.solve_batch(th)
    assert stats.n_solves == 4 * 32768 and stats.summary()["converged_frac"] == 1.0
    before = bulk.LAUNCHES, polish.LAUNCHES
    P.overlap_report(L.mpc_examples("invpend")[0].setup(), B=32768)
    assert bulk.LAUNCHES > before[0] and polish.LAUNCHES > before[1]
    with P.trace(str(tmp_path / "tr")):
        e.solve_batch(th)
        torch.cuda.synchronize()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert [s.name for s in P.spans()] == ["lmpc.engine.solve_batch", "lmpc.small.k1",
                                           "lmpc.small.polish", "lmpc.small.stragglers"]
