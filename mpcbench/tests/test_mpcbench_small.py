"""The readers of invpend-montecarlo's per-layer metrics against hand counts
on a fixed trace: K1's and K2's roofline shares from a fixed history of
the reference's working sets (``workmodel_small``), the device idle inside
the small-m tier's spans a step, and K1's iterations a lane and step.

Run: ``python -m pytest mpcbench/tests -q``.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from mpcbench import harness  # noqa: E402
from mpcbench.trace import Interval, Trace  # noqa: E402

LAYERS = ROOT / "mpcbench" / "layers"
K1 = "void (anonymous namespace)::phase1_kernel<float, 5>(float const*, float const*)"
K2 = "void (anonymous namespace)::polish_kernel<5, 8>(double const*, double const*)"


def reader(name):
    return harness.load_module(LAYERS / f"{name}.py", "test_layer_" + name.replace(".", "_")).read


def _span(name, start_ns, end_ns, parent=-1):
    return SimpleNamespace(name=name, start_ns=start_ns, end_ns=end_ns, parent=parent, call=0)


def _ctx(history=((0, 0), (1, 1), (2, 1), (1, 0)), spans=(), counts=None):
    """Two rollouts of 3 steps of 1000 lanes (6 launches of each kernel,
    K1 1 us and K2 0.5 us each, and kernels the readers must not count),
    invpend's shapes, and the reference's (working-set size, rows added)
    ``history``."""
    tr = Trace()
    tr.units = [Interval("mpcbench.unit", 0.0, 0.01, False), Interval("mpcbench.unit", 0.01, 0.02, False)]
    for i in range(6):
        t = 1e-3 * (i + 1)
        tr.device += [Interval(K1, t, t + 1e-6), Interval(K2, t + 2e-6, t + 2.5e-6),
                      Interval("void my_phase1_kernel<float>()", t + 3e-6, t + 9e-6),
                      Interval("void iu_kernel<float, 40>()", t + 1e-5, t + 2e-5)]
    tr.device.sort(key=lambda d: d.start)
    profiling = SimpleNamespace(spans=lambda: list(spans), counts=lambda: dict(counts or {}),
                                counted=lambda name: [])
    return SimpleNamespace(trace=tr, units=2, params={"lanes": 1000, "steps": 3},
                           shapes={"m": 5, "n": 5, "n_theta": 7},
                           stats={"ws_sizes": [w for w, _ in history], "added": [a for _, a in history]},
                           L=SimpleNamespace(profiling=profiling))


def test_k1_roofline_hand_count():
    # an iteration at s rows: 2 s^2 + 2 m s + 4 m = 2 s^2 + 10 s + 20
    # steps (w, added): (0, 0): s = 0 -> 20; (1, 1): s = 0, 1 -> 20 + 32;
    # (2, 1): s = 1, 2 -> 32 + 48; (1, 0): s = 1 -> 32; mean 184 / 4 = 46
    flops = 6 * 1000 * 46
    # a lane: 4 m float32 values + 4 m bytes + 5 = 105; a launch: the table
    # and G, 4 (2^5 25 + 25) = 3300
    nbytes = 6 * (1000 * 105 + 3300)
    least = max(flops / 67e12, nbytes / 3.35e12)
    assert reader("k1_roofline.invpend")(_ctx()) == pytest.approx(100 * least / 6e-6, rel=1e-12)
    assert least == nbytes / 3.35e12


def test_k2_roofline_hand_count():
    # a lane-step: bounds 2 m n_theta = 70, the solve 2 w^2, U 2 n n_theta
    # + 2 n w = 70 + 10 w: w = 0, 1, 2, 1 -> 140, 152, 168, 152; mean 153
    flops = 6 * 1000 * 153
    # a lane: theta 56 + masks 10 + U, lam, fval, bad 96 = 162; a launch:
    # 8 (2^5 25 + Dth 35 + du, dl 10 + G 25 + HinvET 25 + Uth, f_theta 70 +
    # u_off, f 10 + H 25) = 8000
    nbytes = 6 * (1000 * 162 + 8000)
    least = max(flops / 34e12, nbytes / 3.35e12)
    assert reader("k2_roofline.invpend")(_ctx()) == pytest.approx(100 * least / 3e-6, rel=1e-12)


@pytest.mark.parametrize("name", ["k1_roofline.invpend", "k2_roofline.invpend"])
def test_roofline_silent_without_history_or_kernel(name):
    assert reader(name)(_ctx(history=())) is None
    ctx = _ctx()
    ctx.trace.device = [d for d in ctx.trace.device if "iu_kernel" in d.name]
    assert reader(name)(ctx) is None


def test_small_idle_and_k1_iters_hand_count():
    """Idle inside the lmpc.small.* spans over 6 steps: the K1 and polish
    spans cover [0.5, 2.5] ms, in which the kernels launched at 1 and 2 ms
    run; the rollout's own span around them does not count."""
    spans = [_span("lmpc.rollout.solve", 400_000, 2_600_000),
             _span("lmpc.small.k1", 500_000, 1_500_000, 0),
             _span("lmpc.small.polish", 1_500_000, 2_500_000, 0)]
    ctx = _ctx(spans=spans, counts={"small.lanes": 6000, "small.k1_iters": 7500})
    # busy inside [0.5, 2.5] ms: the four kernels from 1 ms and the four
    # from 2 ms, 1 + 0.5 + 6 + 10 us each time
    busy = 2 * (1e-6 + 0.5e-6 + 6e-6 + 10e-6)
    assert reader("small_idle_ms.invpend")(ctx) == pytest.approx(1e3 * (2e-3 - busy) / 6, rel=1e-9)
    assert reader("k1_iters_per_lane.invpend")(ctx) == 1.25
    silent = _ctx()
    assert reader("small_idle_ms.invpend")(silent) is None
    assert reader("k1_iters_per_lane.invpend")(silent) is None
