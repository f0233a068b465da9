"""The harness on the CPU at small sizes: a run of each cell comes out
correct, its control and each fault the cell can have come out not
correct, a cell, a per-layer metric or a configuration that tracks a
reference added as files alone is found and checked, and no run loads
JAX or the JAX package.

Each cell's CPU sizes are its workload file's ``cpu`` entries, and its
control's ``cpu_control`` where the file has one (satellite-single: its
float32 control reads 6.6e-7 against the 1e-6 limit at Np = 6, so the
control runs the published horizon)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))

import linearmpc_tpu_torch as L  # noqa: E402
from linearmpc_tpu_torch.ops import engine as eng  # noqa: E402
from mpcbench import harness  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
SMALL = {cell: harness.cpu_overrides(cell) for cell in CELLS}
SEED = 4294967311  # above 32 bits


def small(cell, control=False, **kw):
    kw["control"] = control
    return harness.run_cell(cell, SEED, 0.5, False, device="cpu",
                            overrides=harness.cpu_overrides(cell, control), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_and_its_control_does_not(cell):
    ok = small(cell)
    assert ok["correct"], ok["checked"]
    assert ok["failed"] == 0 and ok["attempted"] > 0
    assert "setup_s" in ok["metrics"] and len(ok["metrics"]) == 2
    assert list(ok)[-1] == "checked"
    ctl = small(cell, control=True)
    assert not ctl["correct"], ctl["checked"]


def test_traced_run_reports_per_layer_metrics_it_can_read():
    r = harness.run_cell("crazyflie-sweep", SEED, 0.5, True, device="cpu",
                         overrides=harness.cpu_overrides("crazyflie-sweep"))
    assert r["correct"]
    # no device on the CPU: the device readers find nothing and stay silent
    assert all(m in ("launches_per_batch.sweep",) for m in r["metrics"]) or not r["metrics"]
    assert r["device"]["window_s"] > 0


def _perturbed(sol, scale=1e-6):
    U = sol.U.clone()
    U[:, 0] += scale * (1 + U.abs().amax(1))
    return sol._replace(U=U)


@pytest.mark.parametrize("cell", ["crazyflie-sweep", "satellite-batch"])
def test_batch_faults_fail(cell, monkeypatch):
    orig = eng.SolverEngine.solve_batch

    def altered(self, thetas, warm=None):
        return _perturbed(orig(self, thetas, warm))

    monkeypatch.setattr(eng.SolverEngine, "solve_batch", altered)
    assert not small(cell)["correct"]

    def half(self, thetas, warm=None):
        thetas = torch.as_tensor(thetas)
        h = thetas.shape[0] // 2
        sol = orig(self, thetas[:h], warm)
        pad = lambda t: torch.cat([t, torch.zeros_like(t[:1]).expand(thetas.shape[0] - h, *t.shape[1:])])
        return type(sol)(*(pad(t) for t in sol[:-1]), torch.cat(
            [sol.status, torch.ones(thetas.shape[0] - h, dtype=sol.status.dtype)]))

    monkeypatch.setattr(eng.SolverEngine, "solve_batch", half)
    assert not small(cell)["correct"]


def test_rollout_faults_fail(monkeypatch):
    orig = L.build_rollout

    def frozen(mpc, **kw):
        # the plant step returns its state unchanged
        nx, nu = mpc.model.nx, mpc.model.nu
        return orig(mpc, plant=(np.eye(nx), np.zeros((nx, nu)), np.zeros(nx)))

    monkeypatch.setattr(L, "build_rollout", frozen)
    assert not small("crazyflie-closedloop")["correct"]
    monkeypatch.setattr(L, "build_rollout", orig)

    step = eng.SolverEngine.fused_rollout_solve_iu

    def altered(self, *a):
        U, *rest = step(self, *a)
        return (U + 1e-4 * (1 + U.abs().amax(1, keepdim=True)), *rest)

    monkeypatch.setattr(eng.SolverEngine, "fused_rollout_solve_iu", altered)
    assert not small("crazyflie-closedloop")["correct"]


def test_single_solve_fault_fails(monkeypatch):
    orig = L.MPC.compute_control_trajectory

    def altered(self, x, **kw):
        U = orig(self, x, **kw)
        return U + np.r_[1e-6 * (1 + np.abs(U).max()), np.zeros(len(U) - 1)]

    monkeypatch.setattr(L.MPC, "compute_control_trajectory", altered)
    assert not small("satellite-single")["correct"]


def _copy_with(tmp_path, extra_workload=None, extra_layer=None, files=None, cells=()):
    """A checkout of the benchmark with the program linked in, plus files:
    ``files``, a tree merged into its ``mpcbench/``, whose configurations
    and the workloads named in ``cells`` ((cell, end-to-end metric) pairs)
    are entered in its ``BENCHMARK.json``."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "mpcbench", root / "mpcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(ROOT / "linearmpc_tpu_torch", root / "linearmpc_tpu_torch")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if files:
        shutil.copytree(files, root / "mpcbench", dirs_exist_ok=True)
        for f in sorted((Path(files) / "configs").glob("*.json")):
            cfg = json.loads(f.read_text())
            bench["configs"].append({"name": f.stem, "source": cfg["source"],
                                     "file": f"mpcbench/configs/{f.name}",
                                     "reduced": cfg["reduced"], "why": cfg["deployment"]})
    for name, metric in cells:
        spec = json.loads((root / "mpcbench" / "workloads" / f"{name}.json").read_text())
        bench["workloads"].append({"name": name, "config": spec["config"], "traffic": spec["driver"],
                                   "chips": spec["chips"], "why": spec["why"]})
        next(m for m in bench["end_to_end"] if m["name"] == metric)["workloads"].append(name)
    if extra_workload:
        name, spec = extra_workload
        (root / "mpcbench" / "workloads" / f"{name}.json").write_text(json.dumps(spec))
        bench["workloads"].append({"name": name, "config": spec["config"], "traffic": name,
                                   "chips": 1, "why": spec["why"]})
        for m in bench["end_to_end"]:
            if m["name"] in ("solves_per_s",):
                m["workloads"].append(name)
    if extra_layer:
        name, body, cell = extra_layer
        (root / "mpcbench" / "layers" / f"{name}.py").write_text(body)
        bench["per_layer"].append({"name": name, "unit": "launches", "better": "lower",
                                   "source": "device_trace", "layer": "ops.engine",
                                   "moves": "solves_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run_in(root, code):
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(root)), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_cell_and_metric_are_files_only(tmp_path):
    spec = json.loads((ROOT / "mpcbench/workloads/crazyflie-sweep.json").read_text())
    spec.update(why="a smaller sweep", params=dict(spec["params"], batch=16))
    body = '"""Units run, a test metric."""\n\n\ndef read(ctx):\n    return float(ctx.units)\n'
    root = _copy_with(tmp_path, ("crazyflie-tiny", spec),
                      ("units_run.tiny", body, "crazyflie-tiny"))
    code = ("import json, sys; from mpcbench import harness; "
            "ov = {'trace_units': 2, 'check': {'lanes': 4}}; "
            "a = harness.run_cell('crazyflie-tiny', 11, 0.3, False, device='cpu', overrides=ov); "
            "b = harness.run_cell('crazyflie-tiny', 11, 0.3, True, device='cpu', overrides=ov); "
            "print(json.dumps({'a': a, 'b': b, 'bad': harness.forbidden_modules()}))")
    r = _run_in(root, code)
    assert r["a"]["correct"] and "solves_per_s" in r["a"]["metrics"]
    assert r["b"]["metrics"]["units_run.tiny"]["value"] == 2.0
    assert r["bad"] == []


# planted in a run of the files-only test below: the closed loop solves each
# step at u_{k-2} (theta's last entry is u_prev), and each lane tracks its
# neighbour's reference
_TRACKING_RUNS = r"""
import json, sys
import numpy as np
import linearmpc_tpu_torch as L
from linearmpc_tpu_torch.ops import engine as eng
from mpcbench import harness


def run(cell, control=False):
    return harness.run_cell(cell, int(sys.argv[1]), 0.3, False, device="cpu", control=control,
                            overrides=harness.cpu_overrides(cell, control))


out = {c: [run(c), run(c, control=True)] for c in ("invpend-sweep", "invpend-closedloop")}
step, held = eng.SolverEngine.fused_rollout_solve, {}


def late(self, theta, *a):
    th = theta.clone()
    th[:, -1:] = held.get("u", 0.0)
    held["u"] = theta[:, -1:].clone()
    return step(self, th, *a)


eng.SolverEngine.fused_rollout_solve = late
out["u_prev_late"] = run("invpend-closedloop")
eng.SolverEngine.fused_rollout_solve = step
build = L.build_rollout


def neighbours_r(mpc, **kw):
    roll = build(mpc, **kw)
    return lambda x0s, rs=None, ds=None, ps=None, N=100: roll(x0s, np.roll(rs, 1, axis=0), ds, ps, N=N)


L.build_rollout = neighbours_r
out["wrong_lane_r"] = run("invpend-closedloop")
out["bad"] = harness.forbidden_modules()
print(json.dumps(out))
"""


def test_tracking_config_and_cells_are_files_only(tmp_path):
    """A configuration with Nc < Np, an input-rate weight, R = 0 and a
    tracked reference (invpend, ``tests/files_only/``), a sweep cell and a
    closed-loop cell, added as new files alone: both run correct on the
    CPU, their controls do not, and neither does the closed loop with
    u_prev one step late or with another lane's reference."""
    root = _copy_with(tmp_path, files=HERE / "files_only",
                      cells=[("invpend-sweep", "solves_per_s"),
                             ("invpend-closedloop", "control_steps_per_s")])
    (root / "run_tracking.py").write_text(_TRACKING_RUNS)
    out = subprocess.run([sys.executable, "run_tracking.py", str(SEED)], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    for cell, metric in (("invpend-sweep", "solves_per_s"), ("invpend-closedloop", "control_steps_per_s")):
        ok, ctl = r[cell]
        assert ok["correct"] and ok["failed"] == 0, (cell, ok["checked"])
        assert set(ok["metrics"]) == {metric, "setup_s"}
        assert not ctl["correct"], (cell, ctl["checked"])
    for fault in ("u_prev_late", "wrong_lane_r"):
        assert not r[fault]["correct"], (fault, r[fault]["checked"])
    assert r["bad"] == []


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "mpcbench/run.py"), "--workload",
                          "crazyflie-sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_loads_no_jax():
    code = ("import json, sys; sys.path.insert(0, '.'); from mpcbench import harness; "
            "ov = {'params': {'batch': 8}, 'trace_units': 1, 'check': {'lanes': 2}}; "
            "harness.run_cell('crazyflie-sweep', 5, 0.2, False, device='cpu', overrides=ov); "
            "print(json.dumps({'bad': harness.forbidden_modules(), "
            "'tops': sorted({k.split('.')[0] for k in sys.modules})}))")
    r = _run_in(ROOT, code)
    assert r["bad"] == []
    assert "linearmpc_tpu_torch" in r["tops"]
    assert not {"jax", "jaxlib", "flax", "linearmpc_tpu"} & set(r["tops"])


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("linearmpc_tpu_torchx", type(sys)("linearmpc_tpu_torchx"))
    try:
        assert "linearmpc_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["linearmpc_tpu_torchx"]
