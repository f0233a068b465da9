"""The harness on the CPU at small sizes: a run of each cell comes out
correct, its control and each fault the cell can have come out not
correct, a cell or a per-layer metric added as files alone is found, and
no run loads JAX or the JAX package."""

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

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import linearmpc_tpu_torch as L  # noqa: E402
from linearmpc_tpu_torch.ops import engine as eng  # noqa: E402
from mpcbench import harness  # noqa: E402

# small cells the CPU holds; the satellite at Np = Nc = 6 (12 binary rows)
SMALL = {
    "crazyflie-sweep": {"params": {"batch": 32}, "trace_units": 2, "check": {"lanes": 8}},
    "satellite-batch": {"params": {"batch": 4}, "trace_units": 1, "check": {"lanes": 4},
                        "cfg": {"Np": 6, "Nc": 6}},
    "crazyflie-closedloop": {"params": {"lanes": 8, "steps": 12, "warmup_steps": 12}, "trace_units": 1,
                             "check": {"lanes": 2}},
    "satellite-single": {"trace_units": 2, "check": {"lanes": 4}, "cfg": {"Np": 6, "Nc": 6}},
}
# the float32 control of a single solve reads below the limit at Np = 6
# (6.6e-7 against 1e-6): its test runs the published horizon
CONTROL = {"satellite-single": {"params": {"warmup_units": 1}, "trace_units": 1,
                                "check": {"lanes": 2}}}
SEED = 4294967311  # above 32 bits


def small(cell, control=False, **kw):
    ov = json.loads(json.dumps(CONTROL.get(cell, SMALL[cell]) if control else SMALL[cell]))
    kw["control"] = control
    return harness.run_cell(cell, SEED, 0.5, False, device="cpu", overrides=ov, **kw)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_correct_and_its_control_does_not(cell):
    ok = small(cell)
    assert ok["correct"], ok["checked"]
    assert ok["failed"] == 0 and ok["attempted"] > 0
    assert "setup_s" in ok["metrics"] and len(ok["metrics"]) == 2
    assert list(ok)[-1] == "checked"
    ctl = small(cell, control=True)
    assert not ctl["correct"], ctl["checked"]


def test_traced_run_reports_per_layer_metrics_it_can_read():
    ov = json.loads(json.dumps(SMALL["crazyflie-sweep"]))
    r = harness.run_cell("crazyflie-sweep", SEED, 0.5, True, device="cpu", overrides=ov)
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


def _copy_with(tmp_path, extra_workload=None, extra_layer=None):
    """A checkout of the benchmark with the program linked in, plus files."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "mpcbench", root / "mpcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(ROOT / "linearmpc_tpu_torch", root / "linearmpc_tpu_torch")
    bench = json.loads((root / "BENCHMARK.json").read_text())
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
