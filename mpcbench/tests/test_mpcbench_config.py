"""The benchmark's configurations, files and reference, on the CPU.

Run: ``python -m pytest mpcbench/tests -q`` (the card's cases:
``python -m pytest -m gpu mpcbench/tests -q`` on a machine with CUDA).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "mpcbench"
sys.path.insert(0, str(ROOT))

import linearmpc_tpu_torch as L  # noqa: E402
from linearmpc_tpu_torch.models.examples import mpc_example  # noqa: E402
from linearmpc_tpu_torch.ops.engine import route  # noqa: E402
from mpcbench import harness  # noqa: E402
from mpcbench import reference as ref  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [c["name"] for c in BENCHMARK["configs"]]
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def config(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    mod = harness.load_module(BENCH / "configs" / f"{name}.py", f"test_cfg_{name}")
    return cfg, mod


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_the_published_example(name):
    """The benchmark's plant, through the port's public API, condenses to
    the port's own example: m, n_theta, the route on the card (the one
    that the config file's ``route`` names first), and the mpQP's
    matrices to round-off."""
    cfg, mod = config(name)
    mine = mod.program(L, cfg, mod.plant(cfg)).setup(device="cpu")
    theirs = mpc_example(name).mpc.setup(device="cpu")
    a, b = mine.mpQP, theirs.mpQP
    for field in ("H", "f", "f_theta", "A", "bu", "bl", "W"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.shape == y.shape, field
        if x.size:
            assert np.abs(x - y).max() <= 1e-9 * max(1.0, np.abs(y).max()), field
    ldp = mine.engine.ldp
    assert (ldp.m, ldp.n_theta) == (cfg["sizes"]["m"], cfg["sizes"]["n_theta"])
    path = route("cuda", torch.float32, ldp.m, symmetric=a.is_symmetric,
                 binaries=a.has_binaries, lexicographic=False)
    assert path == route("cuda", torch.float32, theirs.engine.ldp.m, symmetric=b.is_symmetric,
                         binaries=b.has_binaries, lexicographic=False)
    assert path[0] == cfg["route"].split()[0]


@pytest.mark.parametrize("cell", CELLS)
def test_workload_files_name_what_exists(cell):
    spec = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == cell)
    assert spec["config"] == entry["config"]
    assert spec["chips"] == entry["chips"]
    assert spec["why"] == entry["why"]
    assert (BENCH / "configs" / f"{spec['config']}.json").exists()
    assert (BENCH / "configs" / f"{spec['config']}.py").exists()
    assert (BENCH / "drivers" / f"{spec['driver']}.py").exists()
    assert spec["check"]["limits"]
    for m in harness.cell_metrics(BENCHMARK, cell, "per_layer"):
        assert (BENCH / "layers" / f"{m['name']}.py").exists(), m["name"]
    assert len(harness.cell_metrics(BENCHMARK, cell, "end_to_end")) >= 2


def test_benchmark_file_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_port_in_float64(name):
    """The plain reference's optimum against the port's CPU float64 path
    on 4 lanes (2 with binaries: the port's float64 frontier against the
    reference's own branch-and-bound)."""
    cfg, mod = config(name)
    p = mod.plant(cfg)
    mpc = mod.program(L, cfg, p).setup(device="cpu")
    qp = ref.condense(p)
    solver = ref.Solver(qp)
    lo, hi = mod.theta_box(cfg)
    rng = np.random.default_rng(3)
    for _ in range(2 if len(qp.bin_rows) else 4):
        th = lo + (hi - lo) * rng.uniform(size=len(lo))
        U, _, status, _ = mpc.solve(th)
        v = ref.branch_and_bound(solver, th).v if len(qp.bin_rows) else solver.solve(th)[0]
        assert status == 1
        assert np.abs(U - v).max() <= 1e-9 * (1 + np.abs(v).max())


def _invpend(Np, Nc, tracking):
    """invpend's plant from the port's own example (its F, G and C) at
    LinearMPC.jl's weights: Q = diag(1.2^2, 1), R = 0, Rr = 1, |u| <= 2;
    and the port's controller of it."""
    mpc = mpc_example("invpend", Np, Nc).mpc
    mpc.settings.reference_tracking = tracking
    md = mpc.model
    p = ref.Plant(F=md.F, G=md.G, f_off=np.zeros(md.nx), Np=Np, Nc=Nc, C=md.C,
                  Q=np.diag([1.2 ** 2, 1.0]), R=np.zeros((1, 1)), Rr=np.ones((1, 1)),
                  umin=np.array([-2.0]), umax=np.array([2.0]), tracking=tracking)
    return p, mpc.setup(device="cpu")


@pytest.mark.parametrize("Np,Nc,tracking", [(50, 5, True), (50, 5, False), (12, 12, True)],
                         ids=["published", "no-reference", "Nc=Np"])
def test_reference_agrees_with_the_port_on_invpend(Np, Nc, tracking):
    """A control horizon shorter than the prediction horizon, the
    input-rate weight with u_prev in theta, and R = 0: the reference's
    optimum against the port's float64 ``mpc.solve`` on 12 seeded theta
    over the example's range (x, r in +-20; u_prev in +-2), to 1e-9
    relative; theta's layout is the port's."""
    p, mpc = _invpend(Np, Nc, tracking)
    qp = ref.condense(p)
    nx, nr, _, nuprev, _ = mpc.get_parameter_dims()
    assert (qp.nx, qp.nr, qp.nu_prev) == (nx, nr, nuprev) == (4, 2 if tracking else 0, 1)
    assert qp.H.shape == (Nc, Nc) and qp.A.shape[0] == Nc == mpc.engine.ldp.m
    solver = ref.Solver(qp)
    rng = np.random.default_rng(11)
    for _ in range(12):
        th = np.r_[rng.uniform(-20, 20, nx + nr), rng.uniform(-2, 2, nuprev)]
        U, _, status, _ = mpc.solve(th)
        v, _, _, _, st = solver.solve(th)
        assert status == 1 and st == 1
        assert np.abs(U - v).max() <= 1e-9 * (1 + np.abs(v).max())


# entries and norms of the crazyflie and satellite QPs as the reference
# built them before it learnt Nc < Np and Rr
_PINNED = {
    "crazyflie": {("H", 0, 0): 60.55645790862113, ("H", -1, -1): 60.556457908621134,
                  ("f0", 0): -29.59490158082773, ("f0", -1): -25.891035246352764,
                  ("Lth", 0, 0): -0.7452997102235688, ("lo0", -1): -0.07407732668949912,
                  ("Ux", -1, -1): -0.5180356295824048, ("K", 0, 0): -0.7452997102235688,
                  "H": 387.9419434849246, "f0": 175.49191210274353, "A": 6.547645980569189,
                  "Lth": 18.709885518916387, "Ux": 8.570207812974628, "K": 8.33357438063472},
    "satellite": {("H", 0, 0): 8340.1375, ("H", -1, -1): 10.1251, ("H", 1, 5): 1232.6268999999998,
                  ("Fth", 2, 1): 13825.02, ("lo0", -1): -1.0, ("hi0", 0): 1.0,
                  "H": 58853.10325453882, "Fth": 125098.62824985776, "A": 6.324555320336759,
                  "Ux": 1.7320508075688772},
}


@pytest.mark.parametrize("name", sorted(_PINNED))
def test_reference_qp_is_unchanged_at_full_horizon(name):
    """With Nc = Np and no Rr the QP is the one the reference built before
    it learnt either, to 1e-14 relative: a few entries and the norms."""
    cfg, mod = config(name)
    qp = ref.condense(mod.plant(cfg))
    assert (qp.nx, qp.nu_prev) == (cfg["sizes"]["nx"], 0)
    for key, want in _PINNED[name].items():
        if isinstance(key, tuple):
            got, scale = getattr(qp, key[0])[key[1:]], np.linalg.norm(getattr(qp, key[0]))
        else:
            got = scale = np.linalg.norm(getattr(qp, key))
        assert abs(got - want) <= 1e-14 * abs(scale), (key, got, want)


# what ``condense`` refuses: (plant, the changes, the reason it names)
_REFUSED = {
    "Nc<Np prestabilized": ("crazyflie", dict(Nc=3, lqr_terminal=False, uo=None), "prestabilization"),
    "Nc<Np LQR terminal": ("crazyflie", dict(Nc=3, prestabilize=False, uo=None), "LQR terminal"),
    "Nc<Np uo": ("crazyflie", dict(Nc=3, prestabilize=False, lqr_terminal=False), "operating point"),
    "Nc<Np binaries": ("satellite", dict(Nc=3), "binary"),
    "Rr prestabilized": ("crazyflie", dict(Rr=np.eye(4), lqr_terminal=False, uo=None), "prestabilization"),
    "Rr LQR terminal": ("crazyflie", dict(Rr=np.eye(4), prestabilize=False, uo=None), "LQR terminal"),
    "Rr uo": ("crazyflie", dict(Rr=np.eye(4), prestabilize=False, lqr_terminal=False), "operating point"),
    "Rr binaries": ("satellite", dict(Rr=np.eye(3)), "binary"),
    "invpend prestabilized": ("invpend", dict(prestabilize=True, R=np.eye(1)), "prestabilization"),
    "Nc = 0": ("invpend", dict(Nc=0), "outside"),
    "Nc > Np": ("invpend", dict(Nc=11), "outside"),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_reference_refuses_what_it_does_not_implement(case):
    """A combination that ``condense`` does not implement raises, naming
    it, and returns no QP."""
    name, changes, reason = _REFUSED[case]
    if name == "invpend":
        p = _invpend(10, 3, True)[0]
    else:
        cfg, mod = config(name)
        p = mod.plant(cfg)
    with pytest.raises((NotImplementedError, ValueError), match=reason):
        ref.condense(dataclasses.replace(p, **changes))


def test_float32_reference_is_off_by_more_than_the_limit():
    """The control's precision step shows in the numbers compared."""
    cfg, mod = config("crazyflie")
    qp = ref.condense(mod.plant(cfg))
    lo, hi = mod.theta_box(cfg)
    th = lo + (hi - lo) * np.random.default_rng(5).uniform(size=len(lo))
    v64 = ref.Solver(qp).solve(th)[0]
    v32 = ref.Solver(qp, np.float32).solve(th)[0]
    vbf = ref.Solver(qp, "bfloat16").solve(th)[0]
    scale = 1 + np.abs(v64).max()
    assert np.abs(v32 - v64).max() / scale > 1e-8
    assert np.abs(vbf - v64).max() / scale > 1e-4


def test_reference_imports_numpy_only():
    for f in ("reference.py", "check.py", "workmodel.py"):
        tree = ast.parse((BENCH / f).read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert names <= {"__future__", "numpy", "dataclasses", "mpcbench"}, (f, names)
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import mpcbench.reference, mpcbench.check, mpcbench.workmodel; "
         "print(sorted({k.split('.')[0] for k in sys.modules} & "
         "{'torch', 'jax', 'linearmpc_tpu', 'linearmpc_tpu_torch'}))", str(ROOT)],
        capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
