"""The readers of the program's own spans and counters (``mpcbench/spans.py``
and their ``layers/`` files) on the CPU: the helpers on a made-up
timeline, each reader on a made-up store and trace, each reader silent on
a program that has no store and on a window with no device, and the
small cells' traced runs on the CPU, given a device interval, read through
each reader."""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from linearmpc_tpu_torch.profiling import Span  # noqa: E402
from mpcbench import harness  # noqa: E402
from mpcbench import spans as S  # noqa: E402
from mpcbench.trace import Interval, Trace  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ["resolve_useful_pct.sweep", "engine_idle_ms.sweep", "step_host_ms.closedloop",
           "loop_self_ms.closedloop", "finish_idle_ms.bnb", "lane_iters_spread.bnb",
           "nodes_per_lane.bnb", "pre_launch_ms.single", "syncs_per_solve.single"]


def _reader(name):
    return harness.load_module(ROOT / "mpcbench" / "layers" / f"{name}.py", "t_" + name.replace(".", "_"))


def _ns(t):
    return int(round(t * 1e9))


def _ctx(spans, counts=(), device=(("k", 9.9, 10.0),), host=(), window=(0.0, 10.0)):
    """A context whose program recorded ``spans`` ((name, start_s, end_s,
    parent)) and ``counts`` ((name, value)), over a trace of ``device``
    and ``host`` intervals ((name, start_s, end_s))."""
    recs = []
    for name, a, b, parent in spans:
        recs.append(Span(name, _ns(a), _ns(b), parent, recs[parent].call if parent >= 0 else len(recs)))
    counted = list(counts)

    def totals():
        out = {}
        for k, v in counted:
            out[k] = out.get(k, 0) + (sum(v) if isinstance(v, list) else v)
        return out

    prof = SimpleNamespace(spans=lambda: list(recs), counts=totals,
                           counted=lambda name: [v for k, v in counted if k == name])
    tr = Trace(device=[Interval(n, a, b) for n, a, b in device],
               host=[Interval(n, a, b, False) for n, a, b in host],
               units=[Interval("mpcbench.unit", *window, False)])
    return SimpleNamespace(L=SimpleNamespace(profiling=prof), trace=tr, units=1)


def test_busy_and_idle_by_innermost():
    # an outer span [1, 9] holding a child [2, 5]; kernels [0, 1.5], [3, 4], [4.5, 6]
    ctx = _ctx([("lmpc.a", 1.0, 9.0, -1), ("lmpc.b", 2.0, 5.0, 0)],
               device=[("k", 0.0, 1.5), ("k", 3.0, 4.0), ("k", 4.5, 6.0)])
    busy = S.Busy(ctx.trace)
    assert busy.seconds(0.0, 10.0) == pytest.approx(4.0)
    assert busy.seconds(1.0, 3.5) == pytest.approx(1.0)
    assert busy.seconds(4.2, 4.4) == 0.0 and busy.idle(4.2, 4.4) == pytest.approx(0.2)
    idle = S.idle_by_innermost(ctx)
    # b: [2, 5] less [3, 4] and [4.5, 5]; a: [1.5, 2] and [5, 9] less [5, 6]
    assert idle["lmpc.b"] == pytest.approx(1.5)
    assert idle["lmpc.a"] == pytest.approx(0.5 + 3.0)
    assert idle[S.OUTSIDE] == pytest.approx(1.0)
    assert sum(idle.values()) == pytest.approx(10.0 - 4.0)
    sps = S.program_spans(ctx)
    assert S.self_seconds(sps[0], S.children(sps)[0]) == pytest.approx(5.0)
    assert S.self_seconds(sps[0], S.children(sps)[0], only=("lmpc.c",)) == pytest.approx(8.0)


def test_host_events_by_span_and_syncs():
    ctx = _ctx([("lmpc.a", 1.0, 9.0, -1), ("lmpc.b", 2.0, 5.0, 0)],
               host=[("cudaStreamSynchronize", 0.5, 0.6), ("cudaMemcpyAsync", 1.5, 1.6),
                     ("cudaMemcpy", 3.0, 3.1), ("cudaDeviceSynchronize", 6.0, 6.1),
                     ("cudaLaunchKernel", 7.0, 7.1)])
    assert S.host_by_innermost(ctx, S.is_sync) == {S.OUTSIDE: 1, "lmpc.b": 1, "lmpc.a": 1}
    assert S.host_events_inside(ctx, S.named(S.program_spans(ctx), "lmpc.a"), S.is_sync) == 2
    assert not S.is_sync("cudaMemcpyAsync") and not S.is_sync("cudaLaunchKernel")


def test_readers_on_a_made_up_store():
    dev = [("k", 0.0, 1.0), ("k", 2.0, 2.5)]
    sweep = _ctx([("lmpc.engine.solve_batch", 0.0, 3.0, -1), ("lmpc.iu.k3", 0.0, 1.0, 0),
                  ("lmpc.engine.solve_batch", 4.0, 5.0, -1)],
                 counts=[("iu.resolve_lanes", 128), ("iu.resolve_needed", 3),
                         ("iu.resolve_lanes", 128), ("iu.resolve_needed", 1)], device=dev)
    assert _reader("resolve_useful_pct.sweep").read(sweep) == pytest.approx(100 * 4 / 256)
    # idle inside the two batches: 1.5 s of [0, 3], all of [4, 5]
    assert _reader("engine_idle_ms.sweep").read(sweep) == pytest.approx(1e3 * 2.5 / 2)

    loop = _ctx([("lmpc.rollout.run", 0.0, 4.0, -1), ("lmpc.rollout.step", 0.0, 2.0, 0),
                 ("lmpc.rollout.theta", 0.0, 0.2, 1), ("lmpc.rollout.solve", 0.2, 1.5, 1),
                 ("lmpc.rollout.step", 2.0, 3.0, 0), ("lmpc.rollout.solve", 2.1, 2.9, 4)])
    assert _reader("step_host_ms.closedloop").read(loop) == pytest.approx(1.5e3)
    assert _reader("loop_self_ms.closedloop").read(loop) == pytest.approx(1e3 * (0.7 + 0.2) / 2)

    bnb = _ctx([("lmpc.bnb.search", 0.0, 1.0, -1), ("lmpc.bnb.finish", 1.0, 3.0, -1)],
               counts=[("bnb.lanes", 4), ("bnb.nodes", [3, 5, 7, 9]), ("bnb.iters", [1, 1, 1, 5]),
                       ("bnb.lanes", 4), ("bnb.nodes", [1, 1, 1, 1]), ("bnb.iters", [2, 2, 2, 2])],
               device=dev)
    assert _reader("finish_idle_ms.bnb").read(bnb) == pytest.approx(1.5e3)
    assert _reader("nodes_per_lane.bnb").read(bnb) == pytest.approx(28 / 8)
    assert _reader("lane_iters_spread.bnb").read(bnb) == pytest.approx((5 / 2 + 1) / 2)

    single = _ctx([("lmpc.mpc.control", 0.0, 1.0, -1), ("lmpc.bnb.search", 0.25, 0.5, 0),
                   ("lmpc.mpc.control", 2.0, 3.0, -1), ("lmpc.bnb.search", 2.75, 2.8, 2)],
                  device=dev, host=[("cudaStreamSynchronize", 0.6, 0.7),
                                    ("cudaStreamSynchronize", 0.8, 0.9),
                                    ("cudaStreamSynchronize", 2.9, 2.95),
                                    ("cudaStreamSynchronize", 3.5, 3.6)])
    assert _reader("pre_launch_ms.single").read(single) == pytest.approx(1e3 * (0.25 + 0.75) / 2)
    assert _reader("syncs_per_solve.single").read(single) == pytest.approx(1.5)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_silent_without_the_programs_store(name):
    """A program older than the store (no ``spans``/``counts``) gives the
    reader nothing to read: it returns None and does not raise."""
    ctx = _ctx([], device=[("k", 0.0, 1.0)], host=[("cudaStreamSynchronize", 0.5, 0.6)])
    ctx.L = SimpleNamespace(profiling=SimpleNamespace())
    assert _reader(name).read(ctx) is None


def test_each_reader_is_listed_with_its_one_cell():
    listed = {m["name"]: m for m in BENCHMARK["per_layer"]}
    for name in READERS:
        assert len(listed[name]["workloads"]) == 1, name
        assert name.endswith("." + {"crazyflie-sweep": "sweep", "satellite-batch": "bnb",
                                    "crazyflie-closedloop": "closedloop",
                                    "satellite-single": "single"}[listed[name]["workloads"][0]])


@pytest.mark.parametrize("name", READERS)
def test_reader_is_silent_without_a_device_timeline(name):
    """A window with no device timeline (a run on the CPU) gives the
    readers of the program's store nothing either."""
    ctx = _ctx([("lmpc.engine.solve_batch", 0.0, 1.0, -1), ("lmpc.rollout.step", 0.0, 1.0, -1),
                ("lmpc.bnb.finish", 0.0, 1.0, -1), ("lmpc.mpc.control", 0.0, 1.0, -1),
                ("lmpc.bnb.search", 0.5, 0.6, 3)],
               counts=[("iu.resolve_lanes", 8), ("iu.resolve_needed", 1), ("bnb.lanes", 1),
                       ("bnb.nodes", [2]), ("bnb.iters", [3])], device=())
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("cell", ["crazyflie-sweep", "crazyflie-closedloop", "satellite-batch",
                                  "satellite-single"])
def test_small_traced_cell_reads_the_programs_spans(cell, monkeypatch):
    """A small cell's traced run on the CPU, its trace given one device
    interval (the CPU has none): the cell's readers of the program's spans
    and counters all read, and their values are sane."""
    from test_mpcbench_harness import SEED, SMALL

    from mpcbench import trace as tr

    orig = tr.from_profiler

    def with_device(prof):
        t = orig(prof)
        t.device.append(tr.Interval("k", t.window[0], t.window[0] + 1e-9))
        return t

    monkeypatch.setattr(tr, "from_profiler", with_device)
    ov = json.loads(json.dumps(SMALL[cell]))
    r = harness.run_cell(cell, SEED, 0.5, True, device="cpu", overrides=ov)
    assert r["correct"], r["checked"]
    got = {k: v["value"] for k, v in r["metrics"].items() if k in READERS}
    assert set(got) == {n for n in READERS
                        if n in {m["name"] for m in harness.cell_metrics(BENCHMARK, cell, "per_layer")}}
    if cell == "crazyflie-sweep":
        assert 0.0 <= got["resolve_useful_pct.sweep"] <= 100.0
        assert got["engine_idle_ms.sweep"] > 0
    if cell == "crazyflie-closedloop":
        assert 0 < got["loop_self_ms.closedloop"] < got["step_host_ms.closedloop"]
    if cell == "satellite-batch":
        assert got["nodes_per_lane.bnb"] >= 1 and got["lane_iters_spread.bnb"] >= 1
        assert got["finish_idle_ms.bnb"] > 0
    if cell == "satellite-single":
        assert got["pre_launch_ms.single"] > 0 and got["syncs_per_solve.single"] == 0
