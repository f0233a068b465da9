"""One run of one cell: set-up, a measured or traced window, the output
check, and the result line.

Everything particular to a cell is found by name: ``workloads/<cell>.json``
(its configuration, driver, traffic and check), ``configs/<config>.json``
and ``configs/<config>.py`` (the deployment and its plant),
``drivers/<driver>.py`` (how a unit of work calls the program), and, for
each per-layer metric that ``BENCHMARK.json`` lists for the cell,
``layers/<metric>.py``. Adding any of them needs no edit here.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "linearmpc_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that a run may not load, compared
    whole (``linearmpc_tpu_torch`` is not ``linearmpc_tpu``)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    """What a driver and a layer reader get."""

    workload: str
    spec: dict
    cfg: dict
    cfg_mod: object
    plant: object
    seed: int
    device: str
    L: object = None                 # the program's package
    params: dict = field(default_factory=dict)
    qp: object = None                # the reference's condensed problem
    trace: object = None             # trace.Trace of a traced window
    units: int = 0                   # units run in the window
    stats: dict = field(default_factory=dict)   # the check's reference statistics
    shapes: dict = field(default_factory=dict)  # m, n, n_theta of the program's problem

    def stream_seed(self, what: str) -> int:
        """A 63-bit seed for one random stream of this run."""
        h = hashlib.sha256(f"{self.workload}:{self.seed}:{what}".encode()).digest()
        return int.from_bytes(h[:8], "little") >> 1


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cpu_overrides(workload: str, control: bool = False) -> dict:
    """The small sizes a cell's workload file gives for a run on the CPU
    (the tests): its ``cpu`` entries, or for its control ``cpu_control``
    where the file has one. A run on the card never reads them."""
    spec = load_json(HERE / "workloads" / f"{workload}.json")
    return spec.get("cpu_control", spec["cpu"]) if control else spec["cpu"]


def cell_metrics(bench: dict, workload: str, section: str) -> list[dict]:
    """The metrics of ``section`` that the cell reports."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def _sync(device: str):
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             control: bool = False, overrides: dict | None = None) -> dict:
    """Run one cell once and return its result line (a dict). ``control``
    puts the reference, in the precision below the configuration's, in
    the program's place for the output check; ``overrides`` replaces
    workload entries, and under "cfg" configuration entries (tests run
    small cells on the CPU)."""
    spec = load_json(HERE / "workloads" / f"{workload}.json")
    overrides = dict(overrides or {})
    cfg = load_json(HERE / "configs" / f"{spec['config']}.json")
    cfg.update(overrides.pop("cfg", {}))
    for k, v in overrides.items():
        if isinstance(v, dict):
            spec.setdefault(k, {}).update(v)
        else:
            spec[k] = v
    cfg_mod = load_module(HERE / "configs" / f"{spec['config']}.py", f"mpcbench_config_{spec['config']}")
    drv_mod = load_module(HERE / "drivers" / f"{spec['driver']}.py", f"mpcbench_driver_{spec['driver']}")
    bench = benchmark()

    import torch

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import linearmpc_tpu_torch as L
    from mpcbench import reference as ref
    from mpcbench import trace as tr

    plant = cfg_mod.plant(cfg)
    ctx = Context(workload, spec, cfg, cfg_mod, plant, int(seed), device, L=L,
                  params=spec["params"], qp=ref.condense(plant))
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv = drv_mod.Driver(ctx)
    ldp = drv.mpc.engine.ldp
    ctx.shapes = dict(m=ldp.m, n=ldp.n, n_theta=ldp.n_theta)
    drv.warmup()
    _sync(device)

    setup_s = process_age_s()
    out: dict = {}
    if trace:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        units = int(spec["trace_units"])
        with profile(activities=acts) as prof:
            for _ in range(units):
                with record_function(tr.UNIT):
                    drv.unit()
        ctx.trace = tr.from_profiler(prof)
        del prof
        ctx.units = units
    else:
        t0 = time.perf_counter()
        units = 0
        while True:
            drv.unit()
            units += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        ctx.units = units
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    answers = drv.answers()
    attempted, failed = drv.attempted, answers["failed"]
    e2e = {} if trace else drv.end_to_end(elapsed)
    drv.release()
    del drv
    if cuda:
        torch.cuda.empty_cache()

    if control:
        answers = drv_mod.control(ctx, answers)
    numbers, ctx.stats = drv_mod.judge(ctx, answers)
    limits = spec["check"]["limits"]
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checked.values())

    metrics = {}
    if trace:
        for m in cell_metrics(bench, workload, "per_layer"):
            reader = load_module(HERE / "layers" / f"{m['name']}.py", "mpcbench_layer_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if ctx.trace.device:
            out["breakdown"] = tr.breakdown(ctx.trace)
    else:
        e2e["setup_s"] = setup_s
        for m in cell_metrics(bench, workload, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": int(spec.get("chips", 1)),
        "memory_peak_bytes": int(peak),
    }
    if trace:
        lo, hi = ctx.trace.window
        device_info["busy_s"] = tr.busy_seconds(ctx.trace)
        device_info["window_s"] = hi - lo
    if cuda:
        device_info["card"] = power_limit()
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    result.update(out)
    result["units"] = ctx.units
    if ctx.stats.get("ties"):
        result["ties"] = ctx.stats["ties"]
    result["checked"] = checked
    return result
