"""The benchmark's configurations, files and reference, on the CPU.

Run: ``python -m pytest mpcbench/tests -q`` (the card's cases:
``python -m pytest -m gpu mpcbench/tests -q`` on a machine with CUDA).
"""

from __future__ import annotations

import ast
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
    the port's own example: m, n_theta, the route on the card, and the
    mpQP's matrices to round-off."""
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
    assert path[0] == ("hybrid" if a.has_binaries else "iu")


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


@pytest.mark.parametrize("name,lanes", [("crazyflie", 4), ("satellite", 2)])
def test_reference_agrees_with_the_port_in_float64(name, lanes):
    """The plain reference's optimum against the port's CPU float64 path
    (the satellite: the port's float64 frontier against the reference's
    own branch-and-bound)."""
    cfg, mod = config(name)
    p = mod.plant(cfg)
    mpc = mod.program(L, cfg, p).setup(device="cpu")
    qp = ref.condense(p)
    solver = ref.Solver(qp)
    lo, hi = mod.theta_box(cfg)
    rng = np.random.default_rng(3)
    for _ in range(lanes):
        th = lo + (hi - lo) * rng.uniform(size=len(lo))
        U, _, status, _ = mpc.solve(th)
        v = ref.branch_and_bound(solver, th).v if len(qp.bin_rows) else solver.solve(th)[0]
        assert status == 1
        assert np.abs(U - v).max() <= 1e-9 * (1 + np.abs(v).max())


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
