#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``linearmpc_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the two hand-written kernels (K1 ``csrc/bulk.cu``, K2
``csrc/polish.cu``) from the sources, holds each against its plain torch
version on the card, then drives the port's main path through the entry
points a user calls: the golden single solve, the cold B=32768 invpend
batch of the small-m tier, and the warm-started 4096 x 500 closed-loop
rollout. Every phase asserts; any failure exits non-zero. Without CUDA it
exits 1 and prints no result. The second-to-last line is a JSON object
with each kernel's launches in the main-path run, its error against the
plain version and both times; the last line is the JSON verdict.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import linearmpc_tpu_torch as L
from linearmpc_tpu_torch.ops import bulk, cuda_lib, polish
from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy

GOLDEN_U = 1.7612519326
B_COLD = 32768              # cold stream batch (bench.py:90)
B_ROLL, N_ROLL = 4096, 500  # closed-loop rollout (bench.py:215)
N_ORACLE = 256              # lanes held against the NumPy f64 oracle
CASES = (("invpend", None, None), ("aircraft", None, None), ("invpend", 50, 10))


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sample_thetas(case, rng, B):
    """Uniform theta over the example's parameter range; for invpend this
    is x, r in +-20 and uprev in +-2, as bench.py:94-99."""
    _, prange = L.mpc_examples(*case)
    lo, hi = prange.lower(), prange.upper()
    return lo + (hi - lo) * rng.uniform(0.0, 1.0, (B, len(lo)))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_profile(label: str, fn, calls: int, unprofiled_ms: float, top: int = 6) -> str:
    """Device kernel time per call of ``fn`` (``calls`` calls per run) from
    torch.profiler, its share of the unprofiled time per call (the rest is
    device idle), and the largest kernels by self device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA and dev_time(e) > 0),
                     key=dev_time, reverse=True)
    busy = sum(dev_time(e) for e in kernels) / calls
    if busy == 0:
        return f"    profile {label}: the profiler recorded no device kernels (not measured)"
    share = busy / (1e3 * unprofiled_ms)
    lines = [f"    profile {label}: device kernels {busy:.1f} us per call of "
             f"{1e3 * unprofiled_ms:.1f} us unprofiled (busy {100 * share:.1f}%, "
             f"idle {100 - 100 * share:.1f}%); {len(kernels)} kernel names"]
    for e in kernels[:top]:
        lines.append(f"      {dev_time(e) / calls:8.1f} us/call {100 * dev_time(e) / calls / busy:5.1f}%"
                     f"  x{e.count // calls:<3d} {e.key[:80]}")
    return "\n".join(lines)


def oracle_error(ldp, thetas, U):
    err = 0.0
    for i in range(len(thetas)):
        U_ref, *_rest, status = solve_ldp_numpy(ldp, thetas[i])
        if status == 1:
            err = max(err, float(np.max(np.abs(U[i] - U_ref))))
    return err


def phase1_inputs(eng, thetas, dtype):
    """Cold bulk-phase inputs of the tier on the card, in ``dtype``."""
    dev = eng.device
    arr = eng.arrays if dtype == torch.float32 else eng.arrays_hi
    th = torch.as_tensor(thetas, device=dev).to(dtype)
    dt = th @ arr.Dth.T
    B, m = th.shape[0], eng.ldp.m
    return (arr.subset_inv, arr.G, arr.du + dt, arr.dl + dt, eng._eq, eng._immut,
            torch.zeros((B, m), dtype=dtype, device=dev), arr.is_eq.expand(B, m).clone(),
            torch.ones((B, m), dtype=torch.bool, device=dev))


def compare_k1(name, eng, thetas, dtype):
    """K1 against phase1_plain on the same inputs; returns (lam err, kernel
    outputs)."""
    f32 = dtype == torch.float32
    kw = dict(max_iter=eng.bulk_cap if f32 else eng.bulk_cap + 24,
              primal_tol=eng.primal_tol if f32 else 1e-6,
              sign_tol=eng.sign_tol if f32 else 1e-11)
    args = phase1_inputs(eng, thetas, dtype)
    out_k = bulk.phase1(*args, **kw)
    out_p = bulk.phase1_plain(*args, **kw)
    torch.cuda.synchronize()
    lam_k, act_k, side_k, it_k, done_k = out_k
    lam_p, act_p, side_p, it_p, done_p = out_p
    same = (act_k == act_p).all(1) & (side_k == side_p).all(1) & (done_k == done_p)
    frac = 1.0 - same.double().mean().item()
    # f32: at most 0.1% of lanes at invpend m=5 and 2% otherwise, the bar
    # the JAX package sets between its Pallas and XLA paths at m=8
    # (tests/test_rollout.py:254-259); f64: 0.01% everywhere. The kernel
    # sums in the plain version's order without FMA contraction, so the
    # two agree bit for bit unless the card's arithmetic differs.
    bar = (0.001 if eng.ldp.m == 5 else 0.02) if f32 else 1e-4
    # where the working sets agree, lam differs by summation order only
    tol = 1e-4 if f32 else 1e-10
    dl = (lam_k - lam_p).abs()[same]
    rel = (dl / (1.0 + lam_p.abs()[same])).max().item() if dl.numel() else 0.0
    err = dl.max().item() if dl.numel() else 0.0
    log(f"  K1 {name} m={eng.ldp.m} {str(dtype)[6:]}: disagreeing lanes "
        f"{int((~same).sum())}/{len(same)} ({frac:.2e}, bar {bar}), "
        f"max |dlam| {err:.3e}, rel {rel:.3e} (tol {tol}), mean iters "
        f"{it_k.double().mean().item():.2f}, done {done_k.double().mean().item():.4f}")
    check(frac <= bar, f"K1 {name} {dtype}: {frac:.2e} of lanes disagree (bar {bar})")
    check(rel <= tol, f"K1 {name} {dtype}: lam rel err {rel:.3e} > {tol}")
    return err, out_k


def compare_k2(name, eng, thetas, act, side):
    """K2 against polish_plain on the card; returns max |U| and |lam| err."""
    th = torch.as_tensor(thetas, device=eng.device, dtype=torch.float64)
    U_k, lam_k, f_k, bad_k = polish.polish(eng._pd, th, act, side)
    U_p, lam_p, f_p, bad_p = polish.polish_plain(eng._pd, th, act, side)
    torch.cuda.synchronize()
    rel = lambda a, b: ((a - b).abs() / (1.0 + b.abs())).max().item()
    eU, eL, eF = rel(U_k, U_p), rel(lam_k, lam_p), rel(f_k, f_p)
    flags_equal = bool(((bad_k > 1e-8) == (bad_p > 1e-8)).all())
    log(f"  K2 {name} m={eng.ldp.m}: rel err U {eU:.3e}, lam {eL:.3e}, fval {eF:.3e}, "
        f"bad>1e-8 flags equal {flags_equal} ({int((bad_k > 1e-8).sum())} flagged)")
    # both float64, summed in the same order without FMA: 1e-12 relative
    # is a bound on the card's arithmetic differing from the plain ops
    check(eU <= 1e-12 and eL <= 1e-12, f"K2 {name}: U/lam err {eU:.3e}/{eL:.3e} > 1e-12")
    check(flags_equal, f"K2 {name}: bad > 1e-8 flags differ")
    return max((U_k - U_p).abs().max().item(), (lam_k - lam_p).abs().max().item())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[0] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 bound transform
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    # [1] build
    t0 = time.perf_counter()
    for name in ("bulk", "polish"):
        cuda_lib.load(name)
    log(f"[1] built kernels in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in cuda_lib.BUILD_SECONDS.items())})")
    for name, text in cuda_lib.PTXAS_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas {name}: {line.strip()}")

    # [2] K1 and [3] K2 against their plain versions on the card
    log("[2] K1 (bulk phase) vs phase1_plain, cold, B=32768")
    engines, k1_err, k2_err, k2_inputs = {}, None, None, {}
    for case in CASES:
        mpc, _ = L.mpc_examples(*case)
        mpc.setup(device=dev, dtype=torch.float32)
        eng = mpc.engine
        name = "/".join(str(c) for c in case if c is not None)
        th = sample_thetas(case, rng, B_COLD)
        check(th.shape[1] == eng.ldp.n_theta, f"{name}: theta width")
        engines[name] = (mpc, th)
        for dtype in (torch.float32, torch.float64):
            err, out = compare_k1(name, eng, th, dtype)
            if dtype == torch.float32:
                k2_inputs[name] = (out[1], out[2])
                if k1_err is None:
                    k1_err = err
        if eng.ldp.m == 10:
            sol = eng.solve_batch(th)
            U = sol.U[:N_ORACLE].cpu().numpy()
            e = oracle_error(eng.ldp, th[:N_ORACLE], U)
            log(f"  tier at m=10: status==1 {(sol.status == 1).double().mean().item():.6f}, "
                f"max |U - U_oracle| over {N_ORACLE} lanes {e:.3e}")
            check(e <= 1e-9, f"m=10 tier error {e:.3e} > 1e-9")
    log("[3] K2 (polish) vs polish_plain, on the K1 working sets")
    for name, (act, side) in k2_inputs.items():
        mpc, th = engines[name]
        e = compare_k2(name, mpc.engine, th, act, side)
        if k2_err is None:
            k2_err = e

    # the main path: golden, cold batch, rollout -- launches counted here
    bulk.LAUNCHES = 0
    polish.LAUNCHES = 0

    # [4] golden single solve through setup(device="cuda")
    mpc, _ = L.mpc_examples("invpend")
    mpc.setup(device="cuda", dtype=torch.float32)
    u = mpc.compute_control([5.0, 5.0, 0.0, 0.0])
    log(f"[4] golden u = {u[0]:.10f} (expected {GOLDEN_U})")
    check(abs(u[0] - GOLDEN_U) <= 1e-6, f"golden u {u[0]} off by more than 1e-6")

    # [5] cold batched tier
    eng = mpc.engine
    th = sample_thetas(("invpend", None, None), rng, B_COLD)
    th_dev = torch.as_tensor(th, device=dev)
    l1, l2 = bulk.LAUNCHES, polish.LAUNCHES
    sol = eng.solve_batch(th_dev)
    conv = (sol.status == 1).double().mean().item()
    check(torch.isfinite(sol.U).all().item(), "tier: non-finite controls")
    e = oracle_error(eng.ldp, th[:N_ORACLE], sol.U[:N_ORACLE].cpu().numpy())
    log(f"[5] tier B={B_COLD}: status==1 {conv:.6f}, mean iters "
        f"{sol.iters.double().mean().item():.2f}, max |U - U_oracle| over "
        f"{N_ORACLE} lanes {e:.3e}, launches K1 +{bulk.LAUNCHES - l1} K2 +{polish.LAUNCHES - l2}")
    check(conv == 1.0, f"tier: status==1 fraction {conv}")
    check(e <= 1e-9, f"tier error {e:.3e} > 1e-9")
    check(bulk.LAUNCHES > l1 and polish.LAUNCHES > l2, "tier did not launch both kernels")

    # [6] warm-started closed-loop rollout
    rollout = L.build_rollout(mpc)
    x0s = rng.uniform(-0.5, 0.5, (B_ROLL, 4))
    rs = np.zeros((B_ROLL, 2))
    t0 = time.perf_counter()
    res = rollout(x0s, rs, None, N=N_ROLL)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    check(bool((res.status == 1).all()), "rollout: a step with status != 1")
    check(all(torch.isfinite(t).all().item() for t in (res.xs, res.us, res.ys)),
          "rollout: non-finite values")
    ref_mpc, _ = L.mpc_examples("invpend")
    ref_mpc.setup(device="cpu", dtype=torch.float64)
    ref = L.build_rollout(ref_mpc)(x0s[:8], rs[:8], None, N=N_ROLL)
    us, us_ref = res.us[:8].double().cpu(), ref.us
    # state carried in f32 on the card vs f64 on the CPU: round-off drift
    rel_u = ((us - us_ref).abs() / (1.0 + us_ref.abs())).max().item()
    log(f"[6] rollout {B_ROLL} x {N_ROLL}: all status 1, first run {t_first:.2f} s, "
        f"mean iters {res.iters.double().mean().item():.3f}, first 8 lanes vs CPU f64 "
        f"rollout: max rel |du| {rel_u:.3e}")
    check(rel_u <= 1e-5, f"rollout vs CPU f64: {rel_u:.3e} > 1e-5")
    launches = {"bulk": bulk.LAUNCHES, "polish": polish.LAUNCHES}
    log(f"    main-path launches: K1 {launches['bulk']}, K2 {launches['polish']}")
    check(launches["bulk"] > 0 and launches["polish"] > 0, "a kernel was never launched")

    # [7] timings (CUDA events, after warm-up), at the main path's shapes
    args = phase1_inputs(eng, th, torch.float32)
    kw = dict(max_iter=eng.bulk_cap, primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)
    ms_k1 = cuda_ms(lambda: bulk.phase1(*args, **kw), 20)
    ms_k1p = cuda_ms(lambda: bulk.phase1_plain(*args, **kw), 3, warmup=1)
    _, act, side, _, _ = bulk.phase1(*args, **kw)
    ms_k2 = cuda_ms(lambda: polish.polish(eng._pd, th_dev, act, side), 20)
    ms_k2p = cuda_ms(lambda: polish.polish_plain(eng._pd, th_dev, act, side), 20)
    ms_tier = cuda_ms(lambda: eng.solve_batch(th_dev), 10)
    t0 = time.perf_counter()
    rollout(x0s, rs, None, N=N_ROLL)
    torch.cuda.synchronize()
    t_roll = time.perf_counter() - t0
    prof_k1 = device_profile("K1 per launch", lambda: [bulk.phase1(*args, **kw)
                                                       for _ in range(20)], 20, ms_k1)
    prof_k2 = device_profile("K2 per launch", lambda: [
        polish.polish(eng._pd, th_dev, act, side) for _ in range(20)], 20, ms_k2)
    prof_tier = device_profile(f"tier per batch of {B_COLD}",
                               lambda: [eng.solve_batch(th_dev) for _ in range(5)], 5, ms_tier)
    prof_roll = device_profile(f"rollout per step of {B_ROLL} lanes",
                               lambda: rollout(x0s, rs, None, N=50), 50, 1e3 * t_roll / N_ROLL)
    card = card_line()
    log(f"[7] timings on {card}, invpend m=5, B={B_COLD}:")
    log(f"    K1 {ms_k1:.4f} ms vs phase1_plain {ms_k1p:.4f} ms")
    log(f"    K2 {ms_k2:.4f} ms vs polish_plain {ms_k2p:.4f} ms")
    log(f"    tier {ms_tier:.4f} ms/batch = {B_COLD / ms_tier * 1e3:,.0f} solves/s")
    log(f"    rollout {B_ROLL} x {N_ROLL} in {t_roll:.3f} s = "
        f"{B_ROLL * N_ROLL / t_roll:,.0f} control-steps/s")
    for text in (prof_k1, prof_k2, prof_tier, prof_roll):
        log(text)

    kernels = [
        {"name": "K1 bulk phase", "route": "cuda",
         "source": "linearmpc_tpu_torch/csrc/bulk.cu",
         "replaces": "linearmpc_tpu/ops/pallas_solver.py:58",
         "launches": launches["bulk"], "max_abs_err": k1_err,
         "ms": ms_k1, "plain_ms": ms_k1p},
        {"name": "K2 polish", "route": "cuda",
         "source": "linearmpc_tpu_torch/csrc/polish.cu",
         "replaces": "linearmpc_tpu/ops/pallas_polish.py:144",
         "launches": launches["polish"], "max_abs_err": k2_err,
         "ms": ms_k2, "plain_ms": ms_k2p},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
