#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``linearmpc_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the hand-written kernels (K1 ``csrc/bulk.cu``, K2
``csrc/polish.cu``, K3 ``csrc/iu.cu`` and its search entry
``csrc/inc_search.cu``, K4 ``csrc/ciu.cu``, the IU rollout step's epilogue
``csrc/iu_epilogue.cu``, the gather and merge of the small-m warm step's
float64 finish ``csrc/roll_finish.cu``) from the sources, one nvcc each in parallel, holds each against its plain torch version on the card,
and drives the port's three solve paths through the entry points a user
calls, with the launch counts set to 0 just before each path and read just
after:

* small m (invpend, m=5): the golden single solve (also through setup()
  with no device, which must land on the card), the cold B=32768 batch of
  the small-m tier and the warm-started 4096 x 500 rollout [4]-[7];
* the IU tier (invpend 50/8 with the +-18 state box on ks 2..11, m=48):
  the cold B=8192 batch and the 4096 x 500 rollout [8]-[10], with the
  epilogue kernel of a warm rollout step held against its plain version;
* the compact tier (the box on ks 2..31, m=128): the cold B=8192 batch and
  the 2048 x 300 rollout [11]-[13];

then times kernels (the epilogue's step too), tiers and rollouts [14]; holds K3 and K4 against
their plain versions at ragged batch sizes, with a per-lane eq and on their
wide-team paths (K3 f64 at m=160 with R in global memory, K4 f64 at s=96)
[15]; replays, compares and times the K3/K4 launches the paths make
(cold, the second chance, one warm rollout step of each tier) [16]; and
does the same for the K1/K2 launches of the small-m path (the cold tier's
K1, f64 stragglers and K2; a warm rollout step's K1 and K2) and for the
finish's gather and merge on a warm step of invpend-montecarlo's 2,097,152
lanes with every 4096th lane forced to fail, then runs one rollout step
under ``torch.cuda.set_sync_debug_mode("error")`` and counts the syncs of
one cold batch [17]. Then the two paths of hybrid and
prioritized MPC, each with the counts set to 0 just before its run:

* hybrid (the satellite at its reference default, m = 60, 40 binary rows,
  B = 512, through setup() with no device): the incremental node-frontier
  branch-and-bound in one launch of K3's search entry (``csrc/
  inc_search.cu``), held against the CPU float64 frontier and bit for bit
  against its plain version, the same search round by round on the plain
  step (``step_iu_plain``) with the torch management, and against those
  rounds on K3's resumable step, also with the node limit starved at
  B = 64 (status 2); its syncs, solves/s, single-solve
  latency against Ts = 100 ms and the entry's times and bound [18]; the
  closed-loop satellite on the card [19];
* the lexicographic hierarchy (the two-level problem of the JAX bench,
  m = 7, B = 8192): each level on K1's float64 instantiation, held
  against the CPU float64 ``LexSolver`` [20];

then replays the K3 step launches of [18]'s round-by-round run (first,
mid-search, last round) against the plain step [21]. Then the paths that run no kernel of
their own or open new routes, again each counted:

* float32 hybrid at m >= 67 (``invpend_contact`` Np = 4, m = 88, B = 16):
  the frontier rounds on the float64 node arrays, held against the CPU
  float64 frontier, with its rounds, syncs a poll, solves/s and a profile;
  the float64 engine's Cholesky frontier on the same lanes; the JAX bench's
  contact shape (Np = 6, m = 142, B = 4), each incumbent held against the
  float64 re-solve of its fixed-binary QP [22];
* single solves through ``solve_single`` (K1 f32 and f64 for the golden
  u, K3 and the float64 continuation for an infeasible point, -3), float32
  at m = 11 and m = 0, the float64 engine on the card, a non-symmetric H,
  and the B = 1 latency; the single solves' K1 and K3 launches replayed
  against their plain versions [23];

then two numbers not measured before: the small-m tier on aircraft at
its full range, and the lexicographic path at m = 13 against the CPU [24].
Last the offline analyses, whose device work is the float64 LP oracle
(``ops/lp_ipm.py``, torch ops: no kernel of its own) and the batched point
location, each phase timed:

* the LP oracle: 1024 Chebyshev lanes against the CPU run and HiGHS, and
  one IPM chunk's launches an iteration, QR share, syncs and time [25];
* explicit MPC for invpend and ballplate at their default ranges (93 and
  275 regions, the active sets of the HiGHS enumeration), point location
  at B = 32768 against host ``evaluate`` and the float64 implicit engine,
  invpend's BST with the exact-descent check, a checkpoint round trip
  [26];
* certification of invpend over its full range: 8909 regions, worst case
  14, the IPM's device time against the wall [27].

Last the deployment and tooling paths and the multi-device solver, which
run the kernels through new entry points:

* the generated C of invpend (gcc) against the engine on the card on 256
  states, the explicit C against ``evaluate_batch`` on the card, and the
  native C++ CPU runtime against the card at B = 512 [28];
* ``export_compiled`` / ``load_compiled`` at B = 1024 for invpend (K1) and
  the m = 48 problem (K3), the replay bit for bit against a direct
  ``solve_single``, its launches counted alone (path ``export``) [29];
* ``instrument`` on the cold B = 32768 tier, ``overlap_report`` (K1 on a
  second stream beside K2; path ``overlap``) and a profiler trace [30];
* the mp-Schur row-sharded solver on a 1 x 1 mesh (NCCL, a world of one)
  at the JAX bench's m = 1024, B = 256, against the NumPy oracle, and the
  threshold and hybrid rules of ``attach_mesh`` [31].
Every comparison of a kernel with its plain version requires every lane to
agree and the outputs to be equal bit for bit, but the epilogue's: its
float32 products sum in another order than cuBLAS's, so its statuses must
be equal and its values within a tolerance. Every phase asserts; any
failure exits non-zero.
Without CUDA it exits 1 and prints no result. The second-to-last line is
a JSON object with, per kernel, its launches on its path's run (and on
each path), its error against the plain version, its call and device
times, the plain version's time and the bound; the last line is the JSON
verdict.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

import linearmpc_tpu_torch as L
from linearmpc_tpu_torch.ops import bulk, ciu, cuda_lib, iu, iu_epilogue, polish, roll_finish
from linearmpc_tpu_torch import profiling
from linearmpc_tpu_torch.native_runtime import NativeBatchSolver
from linearmpc_tpu_torch.ops.dual_active_set import continue_from_state, solve_single
from linearmpc_tpu_torch.ops.engine import REFINE_ROLL, ROLL_RES, ROLLOUT_TOL, STRAGGLER_ITERS
from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy
# the bound of a kernel (its bytes at HBM3's rate, its operations at the
# card's highest rate for their type): one definition with the port's models
from linearmpc_tpu_torch.profiling import (bound, gi_bound, k1_bound, k2_bound, nbytes,
                                           search_bound, step_bound)

GOLDEN_U = 1.7612519326
B_COLD = 32768              # cold stream batch (bench.py:90)
B_ROLL, N_ROLL = 4096, 500  # closed-loop rollout (bench.py:215)
# the finish's gather and merge at invpend-montecarlo's lanes, every
# FINISH_EVERY-th lane forced to fail (512 lanes for the 256 slots)
B_FINISH, FINISH_EVERY = 2 ** 21, 4096
N_ORACLE = 256              # lanes held against the NumPy f64 oracle
# K1/K2 checks at team sizes of 8 (m = 5, 6) and 16 threads (m = 10); the
# card tests (tests/test_torch_gpu.py) take m = 4 (4 threads) and 8-9 too
CASES = (("invpend", None, None), ("aircraft", None, None), ("invpend", 50, 10))
B_LARGE = 8192              # cold large-m batches (bench.py:313, :485)
B_ROLL_IU, N_ROLL_IU = 4096, 500   # IU rollout (bench.py:364)
B_ROLL_C, N_ROLL_C = 2048, 300     # compact rollout (bench.py:495)
LANE_CASE = Path(__file__).resolve().parent / "tests" / "data" / "compact_lane1929.npz"
B_HYB, HYB_REF = 512, 32  # hybrid satellite batch (bench.py:615), lanes vs CPU f64
# the hybrid search with its node limit starved (the full search takes 5-187
# nodes a lane): the first 64 lanes of [18]'s batch
B_STARVED, HYB_STARVED = 64, 24
B_LEX, LEX_REF = 8192, 256  # lexicographic batch (bench.py:587), lanes vs CPU f64
# the contact problem at m = 88 (tests/test_hybrid.py:370-376), lanes vs CPU
# f64; the JAX bench's contact shape at m = 142 (bench.py:755-760), its batch
# cut from the bench's 8 lanes to 4 to keep the run's time with [25]-[27]
B_CONTACT, CONTACT_REF, B_BENCH_CONTACT = 16, 4, 4
B_LP = 1024                 # LP oracle lanes (tests/test_lp_oracle.py's generator)
B_EVAL = 32768              # explicit point-location batch
CERT_SAMPLE = 8             # every 8th IPM call of [27] replayed under the profiler
KERNELS = ("bulk", "polish", "iu", "ciu", "inc_search", "iu_epilogue", "roll_finish")
# each module's LAUNCHES (roll_finish's: the gather's and the merge's)
COUNTED = dict(bulk=bulk, polish=polish, iu=iu, ciu=ciu, iu_epilogue=iu_epilogue,
               roll_finish=roll_finish)
PATHS = ("small", "iu", "compact", "hybrid", "lex", "contact", "single", "exact", "nonsym",
         "export", "overlap")
# the discrete outputs of K3 / K4 compared lane by lane (index in the returns)
K3_FIELDS = dict(act=1, side=2, iters=3, done=4, infeas=5)
K4_FIELDS = dict(K3_FIELDS, ovf=6, slots=7)


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


def host_profile(label: str, fn, calls: int, top: int = 5) -> str:
    """Kernel launches per call of ``fn`` (``calls`` calls per run) and the
    torch operators that take the most host time, from torch.profiler's
    CPU activity and its CUDA runtime calls (the profiler's own overhead
    included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)
    total = sum(e.self_cpu_time_total for e in events)
    lines = [f"    host profile {label}: {launches / calls:.0f} kernel launches and "
             f"{total / calls / 1e3:.1f} ms of host time per call (profiled)"]
    for e in ops[:top]:
        lines.append(f"      {e.self_cpu_time_total / calls / 1e3:8.3f} ms/call  x{e.count // calls:<5d} "
                     f"{e.key}")
    return "\n".join(lines)


def oracle_error(ldp, thetas, U, status=None):
    """Max |U - U_oracle| over the oracle-feasible lanes; with ``status``
    also the number of lanes whose verdict (1 or -3) the engine's status
    contradicts and the number the oracle decided."""
    err, wrong, decided = 0.0, 0, 0
    for i in range(len(thetas)):
        U_ref, *_rest, s_ref = solve_ldp_numpy(ldp, thetas[i])
        if s_ref == 1:
            err = max(err, float(np.max(np.abs(U[i] - U_ref))))
        if status is not None and s_ref in (1, -3):
            decided += 1
            wrong += int(status[i] != s_ref)
    return err if status is None else (err, wrong, decided)


def reset_counts():
    for mod in COUNTED.values():
        mod.LAUNCHES = 0
    iu.STEP_LAUNCHES = 0
    iu.SEARCH_LAUNCHES = 0
    roll_finish.MERGE_LAUNCHES = 0


def read_counts() -> dict:
    return {**{k: mod.LAUNCHES for k, mod in COUNTED.items()},
            "roll_finish_merge": roll_finish.MERGE_LAUNCHES}


def kernel_device_ms(fn, name: str, window_s: float = 0.05):
    """Mean device time of one launch of the kernels whose name holds
    ``name`` after no letter (iu_kernel is not ciu_kernel), from
    torch.profiler over what ``fn`` launches, repeated to fill a window of
    at least ``window_s`` on the host clock (the profiler recorded no device
    event at all in windows of a few short launches); None where it saw
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(1, min(200, int(window_s / max(time.perf_counter() - t0, 1e-6)) + 1))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and re.search(rf"(?<![A-Za-z_]){name}", e.key)]
    us, n = sum(getattr(e, "self_device_time_total", 0.0) for e in hits), sum(e.count for e in hits)
    if not (us and n):
        seen = sorted({e.key[:70] for e in prof.key_averages()
                       if getattr(e, "device_type", None) == DeviceType.CUDA})
        log(f"      (profiler saw no {name} launch with device time: {len(seen)} device "
            f"event names {seen[:6]}, hits {[(e.key[:70], e.count) for e in hits]})")
        return None
    return us / n / 1e3


def phase1_inputs(eng, thetas, dtype):
    """Cold bulk-phase inputs of the tier on the card, in ``dtype``."""
    dev = eng.device
    arr = eng.arrays if dtype == torch.float32 else eng.arrays_hi
    th = torch.as_tensor(thetas, device=dev).to(dtype)
    dt = th @ arr.Dth.T
    B, m = th.shape[0], eng.ldp.m
    return (arr.subset_inv, arr.G, arr.du + dt, arr.dl + dt, eng._eq, eng._immut,
            torch.zeros((B, m), dtype=dtype, device=dev), arr.is_eq.expand(B, m).contiguous(),
            torch.ones((B, m), dtype=torch.bool, device=dev))


def k1_kw(eng, dtype) -> dict:
    """K1's keywords in the tier: the f32 bulk phase's, or the f64
    continuation's (engine.py's STRAGGLER_ITERS, finish_from_state's tolerances)."""
    if dtype == torch.float32:
        return dict(max_iter=eng.bulk_cap, primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)
    return dict(max_iter=24, primal_tol=1e-6, sign_tol=1e-11)


def equal_outputs(out_k, out_p) -> tuple[int, int]:
    """(lanes whose outputs differ anywhere, float entries that differ) of a
    kernel against its plain version; NaN counts as equal to NaN."""
    B = out_k[0].shape[0]
    bad = torch.zeros(B, dtype=torch.bool, device=out_k[0].device)
    n_float = 0
    for a, b in zip(out_k, out_p):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
        same = same.reshape(B, -1).all(1)
        bad |= ~same
        n_float += int((~same).sum()) if a.is_floating_point() else 0
    return int(bad.sum()), n_float


def compare_k1(name, eng, thetas, dtype):
    """K1 against phase1_plain on the same inputs: no lane may differ, bit
    for bit (the kernel sums in the plain version's order without FMA
    contraction). Returns (max |dlam|, kernel outputs)."""
    args = phase1_inputs(eng, thetas, dtype)
    kw = k1_kw(eng, dtype)
    out_k = bulk.phase1(*args, **kw)
    out_p = bulk.phase1_plain(*args, **kw)
    torch.cuda.synchronize()
    n_bad, n_float = equal_outputs(out_k, out_p)
    err = (out_k[0] - out_p[0]).abs().max().item()
    log(f"  K1 {name} m={eng.ldp.m} {str(dtype)[6:]}: disagreeing lanes {n_bad}/{len(out_k[0])}, "
        f"unequal float entries {n_float} (0 required), max |dlam| {err:.3e}, mean iters "
        f"{out_k[3].double().mean().item():.2f}, done {out_k[4].double().mean().item():.4f}")
    check(n_bad == 0, f"K1 {name} {dtype}: {n_bad} lanes differ from phase1_plain")
    return err, out_k


def compare_k2(name, eng, thetas, act, side):
    """K2 against polish_plain on the card, bit for bit; returns max |U| and
    |lam| err."""
    th = torch.as_tensor(thetas, device=eng.device, dtype=torch.float64)
    out_k = polish.polish(eng._pd, th, act, side)
    out_p = polish.polish_plain(eng._pd, th, act, side)
    torch.cuda.synchronize()
    n_bad, n_float = equal_outputs(out_k, out_p)
    err = max((out_k[0] - out_p[0]).abs().max().item(), (out_k[1] - out_p[1]).abs().max().item())
    log(f"  K2 {name} m={eng.ldp.m}: disagreeing lanes {n_bad}/{len(th)}, unequal entries "
        f"{n_float} (0 required), max |dU|, |dlam| {err:.3e}, "
        f"{int((out_k[3] > 1e-8).sum())} lanes with bad > 1e-8")
    check(n_bad == 0, f"K2 {name}: {n_bad} lanes differ from polish_plain")
    return err


def largem_mpc(k_hi: int, device, dtype):
    """invpend Np=50, Nc=8 with the +-18 state box on ks 2..k_hi-1
    (bench.py:308-310, :398-400): m = 48 at k_hi=12, m = 128 at k_hi=32."""
    mpc, _ = L.mpc_examples("invpend", 50, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, k_hi))
    return mpc.setup(device=device, dtype=dtype)


def largem_thetas(rng, B, box):
    """x, r in +-box and u_prev in +-2 (bench.py:314-317, :403-406)."""
    return np.hstack([rng.uniform(-box, box, (B, 4)), rng.uniform(-box, box, (B, 2)),
                      rng.uniform(-2, 2, (B, 1))])


def gi_inputs(eng, thetas, dtype):
    """Cold bulk-phase inputs of the large-m tiers on the card, in ``dtype``:
    (G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0) and the kernel
    keywords (the f32 bulk phase's, or the f64 re-solve's)."""
    f32 = dtype == torch.float32
    G, Gs = (eng._G32, eng._Gs32) if f32 else (eng._G64, eng._Gs64)
    arr = eng.arrays if f32 else eng.arrays_hi
    th = torch.as_tensor(thetas, device=eng.device).to(dtype)
    B, m = th.shape[0], eng.ldp.m
    args = (G, Gs, arr.du + th @ arr.Dth.T, arr.dl + th @ arr.Dth.T, eng._eq, eng._immut,
            torch.zeros((B, m), dtype=dtype, device=eng.device), arr.is_eq.expand(B, m),
            torch.ones((B, m), dtype=torch.bool, device=eng.device))
    kw = (dict(max_iter=eng.bulk_cap, primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)
          if f32 else dict(max_iter=eng.bulk_cap + 24, primal_tol=1e-6, sign_tol=1e-11))
    return args, kw


def compare_gi(label, out_k, out_p, fields, lam_i, inv_i, dtype):
    """A GI kernel's outputs against its plain version's: lanes whose
    discrete state disagrees (per field and in all), and on the agreeing
    lanes the max |dlam| and the number of lam and inverse entries that
    differ at all. No lane may disagree, and lam and the inverse must be
    equal bit for bit (NaN where both are): both sum in the same order
    without multiply-add contraction and pass NaN on alike. Returns the
    max |dlam|."""
    B = out_k[0].shape[0]
    same = torch.ones(B, dtype=torch.bool, device=out_k[0].device)
    parts = []
    for name, i in fields.items():
        a, b = out_k[i], out_p[i]
        eq = (a == b) if a.dim() == 1 else (a == b).all(1)
        parts.append(f"{name} {int((~eq).sum())}")
        same &= eq

    def n_diff(i):  # entries that differ on the agreeing lanes (NaN == NaN)
        a, b = out_k[i].reshape(B, -1)[same], out_p[i].reshape(B, -1)[same]
        return int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())

    n_bad = int((~same).sum())
    dlam = (out_k[lam_i] - out_p[lam_i]).abs()[same]
    err = float(torch.nan_to_num(dlam, nan=0.0).max()) if n_bad < B else float("inf")
    d_lam, d_inv = n_diff(lam_i), n_diff(inv_i)
    log(f"  {label} {str(dtype)[6:]}: disagreeing lanes {n_bad}/{B} ({', '.join(parts)}), "
        f"max |dlam| {err:.3e}, unequal entries on agreeing lanes: lam "
        f"{d_lam}, inverse {d_inv} (0 required), mean iters "
        f"{out_k[3].double().mean().item():.2f}, done {out_k[4].double().mean().item():.4f}, "
        f"infeas {out_k[5].double().mean().item():.4f}")
    check(n_bad == 0, f"{label} {dtype}: {n_bad} of {B} lanes disagree")
    check(d_lam == 0 and d_inv == 0,
          f"{label} {dtype}: {d_lam} lam / {d_inv} inverse entries differ on agreeing lanes")
    return err


def epilogue_inputs(eng, roll, x0s, rs, step: int = 10):
    """The (thetas, act, side, done, infeas, R) with which the rollout's
    warm step ``step`` (from 0) enters the epilogue kernel, every 7th lane
    from the 5th flagged infeasible and every 11th from the 3rd not done,
    so that statuses -3 and -1 come beside 1."""
    calls = record_calls(eng, "_rollout_epilogue_cuda",
                         lambda: roll(x0s, rs, None, N=step + 1))
    th, act, side, done, infeas, R = calls[step][0]
    done, infeas = done.clone(), infeas.clone()
    infeas[5::7] = True
    done[3::11] = False
    return th, act, side, done, infeas, R


def run_epilogue(eng, th, act, side, done, infeas, R):
    """The epilogue kernel alone on one step's inputs, on the engine's
    statics: (U, lam, status, R_new)."""
    return iu_epilogue.epilogue(*eng._epilogue_statics, th, R, act, side, done, infeas,
                                refine=REFINE_ROLL, res_tol=ROLL_RES)


def compare_epilogue(label, eng, args) -> float:
    """The epilogue kernel against ``_rollout_epilogue_plain`` on one
    step's inputs: statuses equal on every lane, every status of the inputs
    present, non-finite entries equal, and the finite ones within 1e-6 (U,
    lam) and 1e-5 (R) as max |a - b| / (1 + |b|), the benchmark's ``u_err``
    form. Returns the max |dU|, |dlam|."""
    out_k = run_epilogue(eng, *args)
    out_p = eng._rollout_epilogue_plain(*args)
    torch.cuda.synchronize()
    n_st = int((out_k[2] != out_p[2]).sum())
    seen = set(out_k[2].unique().tolist())
    errs, abs_err = [], 0.0
    for name, i, tol in (("U", 0, 1e-6), ("lam", 1, 1e-6), ("R", 3, 1e-5)):
        a, b = out_k[i].double(), out_p[i].double()
        same_nf = (torch.equal(a.isnan(), b.isnan()) and torch.equal(a.isinf(), b.isinf())
                   and torch.equal(a[a.isinf()], b[b.isinf()]))
        fin = torch.isfinite(b)
        d = (a[fin] - b[fin]).abs()
        rel = float((d / (1.0 + b[fin].abs())).max()) if d.numel() else 0.0
        if i < 3 and d.numel():
            abs_err = max(abs_err, float(d.max()))
        errs.append(f"{name} {rel:.3e} (<= {tol:.0e})")
        check(same_nf, f"{label}: {name}'s non-finite entries differ")
        check(rel <= tol, f"{label}: {name} off by {rel:.3e} > {tol:.0e}")
    log(f"  {label}: B={out_k[2].shape[0]}, m={eng.ldp.m}: status differs on {n_st} lanes "
        f"(statuses {sorted(seen)}); max |a - b| / (1 + |b|): {', '.join(errs)}; "
        f"max |dU|, |dlam| {abs_err:.3e}")
    check(n_st == 0, f"{label}: status differs on {n_st} lanes")
    check({-3, -1, 1} <= seen, f"{label}: statuses {sorted(seen)} lack one of -3, -1, 1")
    return abs_err


def epilogue_bound(eng, args, out) -> tuple[float, str]:
    """The epilogue kernel's bound on one step's data: its inputs, statics
    and outputs once; per lane the Newton-Schulz pass's two m^3
    multiply-adds in float32 and, per Richardson pass, an m^2 product by
    G_solve (float64) and by R (float32), with U's and the bounds'
    products (both types at the card's one peak, ``profiling.bound``)."""
    B, m = args[5].shape[0], args[5].shape[1]
    n, nth = eng.ldp.n, args[0].shape[1]
    flops = B * (4.0 * m ** 3 + (REFINE_ROLL + 1) * 4.0 * m * m + 2.0 * n * (m + nth)
                 + 2.0 * m * nth)
    return bound(nbytes(*eng._epilogue_statics, *args, *out), flops, torch.float32)


def warm_gi_inputs(eng, out, thetas, rng):
    """Warm bulk-phase inputs as a rollout step enters the kernel: the f32
    state ``out`` of a batch (lam, act, side) entering the next batch of
    thetas (each lane moved by N(0, 0.5)); returns (args, kw) with
    ``retry_infeas`` set."""
    th = thetas + rng.normal(0.0, 0.5, thetas.shape)
    args, kw = gi_inputs(eng, th, torch.float32)
    return args[:6] + (out[0], out[1] | eng.arrays.is_eq, out[2]), dict(kw, retry_infeas=True)


def record_calls(module, name: str, run) -> list:
    """The (args, kwargs) of every call of ``module.name`` while ``run()``
    runs (the launches a path makes, to replay them alone)."""
    calls, orig = [], getattr(module, name)

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    setattr(module, name, rec)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return calls


def gi_launches(eng_iu, mpc_iu, th_iu, eng_c, mpc_c, th_c, rng) -> dict:
    """The K3/K4 launches of the large-m paths, as (fn, args, kwargs) by
    label: the cold bulk phases of both tiers, the compact tier's second
    chance (the 128 worst lanes, warm, s2 slots, retry) and one warm
    rollout step of each tier (the 11th; K3 at 4096 lanes, K4 at 2048)."""
    out = {}
    args, kw = gi_inputs(eng_iu, th_iu, torch.float32)
    out["K3 cold f32"] = (iu.phase1_iu, args + (eng_iu.iu_R0_init(len(th_iu)),), kw)
    args, kw = gi_inputs(eng_c, th_c, torch.float32)
    slots0, Rw0 = eng_c._ciu_cold_carry(len(th_c))
    out["K4 cold f32"] = (ciu.phase1_ciu, args + (slots0, Rw0),
                          dict(kw, max_iter=eng_c.bulk_cap_p))
    th_dev = torch.as_tensor(th_c, device=eng_c.device)
    calls = record_calls(ciu, "phase1_ciu", lambda: eng_c.solve_batch(th_dev))
    a, k = next(c for c in calls if c[0][9].shape[1] == eng_c._ciu_s2
                and c[1].get("retry_infeas"))
    out["K4 second chance"] = (ciu.phase1_ciu, a, k)
    for label, mod, name, mpc, B in (("K3 warm rollout step", iu, "phase1_iu", mpc_iu, B_ROLL_IU),
                                     ("K4 warm rollout step", ciu, "phase1_ciu", mpc_c, B_ROLL_C)):
        x0s, rs = rng.uniform(-0.25, 0.25, (B, 4)), np.zeros((B, 2))
        calls = record_calls(mod, name, lambda: L.build_rollout(mpc)(x0s, rs, None, N=11))
        a, k = calls[10]
        out[label] = (getattr(mod, name), a, k)
    return out


def off_path_cases(eng_iu, eng_c, eng_160, big=8193, per_lane=4096, wide=512):
    """(label, engine, B, dtype, entry) of the K3/K4 comparisons off the
    paths' shapes: cold from one shared entry inverse at one lane, one lane
    more than a block holds and ``big``; a per-lane eq; and the wide-team
    paths, K3 f64 at m=160 (R in global memory) and K4 f64 at s=96."""
    f32, f64 = torch.float32, torch.float64
    return [("K3 B=1", eng_iu, 1, f32, "cold"),
            ("K3 B=17 (a block's lanes + 1)", eng_iu, 17, f32, "cold"),
            (f"K3 B={big}", eng_iu, big, f32, "cold"),
            (f"K3 per-lane eq B={per_lane}", eng_iu, per_lane, f32, "eq"),
            (f"K3 m=160 R in global memory B={wide}", eng_160, wide, f64, "cold"),
            ("K4 B=1", eng_c, 1, f32, "cold"),
            ("K4 B=17 (a block's lanes + 1)", eng_c, 17, f32, "cold"),
            (f"K4 B={big}", eng_c, big, f32, "cold"),
            (f"K4 per-lane eq B={per_lane}", eng_c, per_lane, f32, "eq"),
            (f"K4 s=96 (wide team) B={wide}", eng_c, wide, f64, "s96")]


def compare_off_path(cases):
    """Each case's kernel against its plain version (compare_gi)."""
    for label, eng, B, dtype, how in cases:
        rng = np.random.default_rng(B)
        args, kw = gi_inputs(eng, largem_thetas(rng, B, 10.0), dtype)
        hi = eng.arrays if dtype == torch.float32 else eng.arrays_hi
        m = eng.ldp.m
        if how == "eq":
            eq = torch.as_tensor(rng.uniform(size=(B, m)) < 0.05, device=eng.device)
            args = args[:4] + (eq, args[5], args[6], eq, args[8])
        if label.startswith("K3"):
            inv = (iu.init_R_batch(hi.G_solve, args[7]) if how == "eq"
                   else torch.eye(m, dtype=dtype, device=eng.device))
            fn, plain, fields, inv_i = iu.phase1_iu, iu.phase1_iu_plain, K3_FIELDS, 6
            args = args + (inv,)
        else:
            if how == "cold":
                slots0, Rw0 = eng._ciu_cold_carry(B)
                kw = dict(kw, max_iter=eng.bulk_cap_p)
            else:
                Rw0, slots0, _ = ciu.init_compact_batch(hi.G_solve, args[7],
                                                        96 if how == "s96" else eng.ciu_s_max)
            fn, plain, fields, inv_i = ciu.phase1_ciu, ciu.phase1_ciu_plain, K4_FIELDS, 8
            args = args + (slots0, Rw0)
        out_k = fn(*args, **kw)
        out_p = plain(*args, **kw)
        if out_k[0].is_cuda:
            torch.cuda.synchronize()
        compare_gi(label, out_k, out_p, fields, 0, inv_i, dtype)


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def replay_launches(launches: dict, timed: bool = True) -> dict:
    """Each recorded K3/K4 launch (``gi_launches``) against its plain
    version, then its call time, device time, plain time and bound;
    returns those numbers by label."""
    rows = {}
    for label, (fn, args, kw) in launches.items():
        k3 = fn is iu.phase1_iu
        plain = iu.phase1_iu_plain if k3 else ciu.phase1_ciu_plain
        out_k = fn(*args, **kw)
        out_p = plain(*args, **kw)
        compare_gi(label, out_k, out_p, K3_FIELDS if k3 else K4_FIELDS, 0, 6 if k3 else 8,
                   args[2].dtype)
        if not timed:
            continue
        ms = cuda_ms(lambda: fn(*args, **kw), 10)
        dev_ms = kernel_device_ms(lambda: [fn(*args, **kw) for _ in range(5)],
                                  "iu_kernel" if k3 else "ciu_kernel")
        ms_p = cuda_ms(lambda: plain(*args, **kw), 1, warmup=0)
        b_ms, b_by = gi_bound(args, out_k)
        log(f"    {label}: B={args[2].shape[0]}, s={args[-1].shape[-1]}, cap {kw['max_iter']}, "
            f"retry {bool(kw.get('retry_infeas'))}, iterations mean "
            f"{out_k[3].double().mean().item():.3f} max {int(out_k[3].max())}: call {ms:.4f} ms, "
            f"device {fmt_ms(dev_ms)}, plain {ms_p:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        rows[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)
    return rows


def small_launches(mpc, th_dev, x0s, rs) -> dict:
    """The K1/K2 launches of the small-m path, as (fn, args, kwargs) by
    label: the cold tier's f32 bulk phase, its f64 stragglers and its K2,
    and the K1 and K2 of the 11th step of the rollout."""
    eng = mpc.engine
    out = {}
    k2 = []
    k1 = record_calls(bulk, "phase1", lambda: k2.extend(record_calls(
        polish, "polish", lambda: eng.solve_batch(th_dev))))
    a, k = next(c for c in k1 if c[0][2].dtype == torch.float32)
    out[f"K1 cold f32 B={a[2].shape[0]}"] = (bulk.phase1, a, k)
    a, k = next(c for c in k1 if c[0][2].dtype == torch.float64)
    out[f"K1 f64 stragglers B={a[2].shape[0]}"] = (bulk.phase1, a, k)
    out[f"K2 cold B={k2[0][0][2].shape[0]}"] = (polish.polish, *k2[0])
    k2 = []
    k1 = record_calls(bulk, "phase1", lambda: k2.extend(record_calls(
        polish, "polish", lambda: L.build_rollout(mpc)(x0s, rs, None, N=11))))
    # each step's float64 finish launches K1 and K2 again, on its slots
    B = len(x0s)
    k1, k2 = ([c for c in calls if c[0][2].shape[0] == B] for calls in (k1, k2))
    out[f"K1 warm rollout step B={B}"] = (bulk.phase1, *k1[10])
    out[f"K2 warm rollout step B={B}"] = (polish.polish, *k2[10])
    return out


def replay_small(launches: dict) -> dict:
    """Each recorded K1/K2 launch (``small_launches``) against its plain
    version (bit for bit), then its call, device and plain time and its
    bound; returns the numbers by kernel and label."""
    rows = {}
    for label, (fn, args, kw) in launches.items():
        k1 = fn is bulk.phase1
        plain = bulk.phase1_plain if k1 else polish.polish_plain
        out_k = fn(*args, **kw)
        out_p = plain(*args, **kw)
        torch.cuda.synchronize()
        n_bad, n_float = equal_outputs(out_k, out_p)
        check(n_bad == 0, f"{label}: {n_bad} lanes differ from the plain version")
        ms = cuda_ms(lambda: fn(*args, **kw), 20)
        dev_ms = kernel_device_ms(lambda: [fn(*args, **kw) for _ in range(5)],
                                  "phase1_kernel" if k1 else "polish_kernel")
        ms_p = cuda_ms(lambda: plain(*args, **kw), 1, warmup=1)
        b_ms, b_by = k1_bound(args, out_k) if k1 else k2_bound(args[0], args, out_k)
        it = (f"iterations mean {out_k[3].double().mean().item():.3f} max {int(out_k[3].max())}"
              f" (cap {kw['max_iter']}), " if k1 else "")
        log(f"    {label}: disagreeing lanes {n_bad}/{len(out_k[0])}, unequal entries {n_float}; "
            f"{it}call {ms:.4f} ms, device {fmt_ms(dev_ms)}, plain {ms_p:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
        rows.setdefault("K1" if k1 else "K2", {})[label] = dict(
            ms=ms, device_ms=dev_ms, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)
    return rows


def roll_finish_phase(mpc) -> dict:
    """The float64 finish's gather and merge (``csrc/roll_finish.cu``) on
    the inputs of a warm rollout step at invpend-montecarlo's lanes
    (``B_FINISH``, x0 and r in +-1), every ``FINISH_EVERY``-th lane forced to
    fail: each kernel against its plain version, bit for bit (the gather
    takes the first 256 of the 512 failing lanes; the merge, fed the
    continuation of those slots, writes exactly their lanes), then its call,
    device and plain time and its bound (its bytes at HBM3's rate); returns
    the numbers by kernel."""
    eng = mpc.engine
    rng = np.random.default_rng(21)
    x0 = rng.uniform(-1.0, 1.0, (B_FINISH, 4)).astype(np.float32)
    r = rng.uniform(-1.0, 1.0, (B_FINISH, 2)).astype(np.float32)
    merges = []
    gathers = record_calls(roll_finish, "gather", lambda: merges.extend(record_calls(
        roll_finish, "merge", lambda: L.build_rollout(mpc)(x0, r, None, N=2))))
    ok, K, th64, lam, act, side, iters = gathers[1][0]  # the warm step's
    base = merges[1][0][9:]
    ok = ok.clone()
    ok[::FINISH_EVERY] = False
    g_in = (ok, K, th64, lam, act, side, iters)
    out_k = roll_finish.gather(*g_in)
    out_p = roll_finish.gather_plain(*g_in)
    torch.cuda.synchronize()
    g_bad = sum(not torch.equal(a, b) for a, b in zip(out_k, out_p))
    failing = torch.nonzero(~ok).squeeze(1)
    check(g_bad == 0 and bool(out_k[1].all()) and torch.equal(out_k[0], failing[:K]),
          f"finish gather: {g_bad} of its outputs differ from gather_plain, or it took other "
          f"than the first {K} of {len(failing)} failing lanes")
    idx, take, th_k, lam_k, act_k, side_k, iters_k = out_k
    fin = continue_from_state(eng.arrays_hi, th_k, lam_k, act_k, side_k, iters_k,
                              max_iter=STRAGGLER_ITERS)
    U_f, lam_f, _fval, bad_f = polish.polish(eng._pd, th_k, fin.active, fin.side)
    upd = (idx, take, U_f, lam_f, fin.active, fin.side, fin.iters, fin.done, bad_f)
    into_k, into_p = [t.clone() for t in base], [t.clone() for t in base]
    roll_finish.merge(*upd, *into_k, tol=ROLLOUT_TOL)
    roll_finish.merge_plain(*upd, *into_p, tol=ROLLOUT_TOL)
    torch.cuda.synchronize()
    m_bad = sum(not torch.equal(a, b) for a, b in zip(into_k, into_p))
    rest = torch.ones(B_FINISH, dtype=torch.bool, device=ok.device)
    rest[idx] = False
    moved = sum(not torch.equal(a[rest], b[rest]) for a, b in zip(into_k, base))
    check(m_bad == 0 and moved == 0,
          f"finish merge: {m_bad} outputs differ from merge_plain, {moved} moved off its lanes")
    n_fixed = int((into_k[5][idx] == 1).sum())
    rows = {}
    n_u, m = base[0].shape[1], lam.shape[1]
    row_read = th64.shape[1] * 8 + m * (4 + 1 + 1) + 4   # a slot's lane: th, lam, act, side, iters
    row_written = n_u * 8 + m * (8 + 1 + 1) + 4 + 4      # a taken lane: U, lam, act, side, iters, status
    for kind, fn, plain, args, into, name, n_bytes in (
            ("gather", roll_finish.gather, roll_finish.gather_plain, g_in, (), "gather_kernel",
             ok.numel() * (1 + 4) + K * row_read + nbytes(*out_k)),
            ("merge", roll_finish.merge, roll_finish.merge_plain, upd, into_k, "merge_kernel",
             nbytes(*upd) + K * row_written)):
        kw = {} if kind == "gather" else {"tol": ROLLOUT_TOL}
        ms = cuda_ms(lambda: fn(*args, *into, **kw), 20)
        dev_ms = kernel_device_ms(lambda: [fn(*args, *into, **kw) for _ in range(5)], name)
        ms_p = cuda_ms(lambda: plain(*args, *(into_p if into else ()), **kw), 3, warmup=1)
        b_ms, b_by = bound(n_bytes, 0.0, torch.float64)
        log(f"    finish {kind}, B={B_FINISH}, {K} slots of {len(failing)} failing lanes: "
            f"unequal outputs {g_bad if kind == 'gather' else m_bad}; call {ms:.4f} ms"
            f"{' (with its cumsum)' if kind == 'gather' else ''}, device {fmt_ms(dev_ms)}, "
            f"plain {ms_p:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}, {n_bytes} bytes)")
        rows[kind] = dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=ms_p,
                          bound_ms=b_ms, bound_by=b_by)
    log(f"    the continuation turned {n_fixed} of the {K} lanes taken to status 1")
    return rows


def sync_checks(mpc, th_dev, x0s, rs) -> int:
    """One warm rollout step of the small-m path under the sync debug mode
    "error" (it must make no device-to-host copy or synchronize), then the
    syncs of one cold batch under "warn"; returns that count."""
    eng = mpc.engine
    steps = record_calls(eng, "fused_rollout_solve",
                         lambda: L.build_rollout(mpc)(x0s, rs, None, N=11))
    a, k = steps[10]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.fused_rollout_solve(*a, **k)
    except RuntimeError as e:
        fail(f"the small-m rollout step made a host sync: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.solve_batch(th_dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def status_line(sol) -> str:
    st = sol.status
    return (f"status 1 {(st == 1).double().mean().item():.6f}, -3 "
            f"{(st == -3).double().mean().item():.6f}, -1 {int((st == -1).sum())} lanes")


def rollout_check(label, mpc, k_hi, rng, B, N, ref_lanes):
    """A warm-started large-m closed loop from x0 in +-0.25 (bench.py:368,
    :496): every step converged, no infeasible step, finite values; with
    ``ref_lanes`` the first lanes against the port's CPU f64 rollout.
    Returns (rollout, x0s, rs, first-run seconds)."""
    rollout = L.build_rollout(mpc)
    x0s = rng.uniform(-0.25, 0.25, (B, 4))
    rs = np.zeros((B, 2))
    t0 = time.perf_counter()
    res = rollout(x0s, rs, None, N=N)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    conv = (res.status == 1).double().mean().item()
    infeas = (res.status == -3).double().mean().item()
    finite = all(torch.isfinite(t).all().item() for t in (res.xs, res.us, res.ys))
    msg = (f"{label} {B} x {N}: converged {conv:.6f}, infeasible {infeas:.6f}, finite "
           f"{finite}, first run {t_first:.2f} s, mean iters {res.iters.double().mean().item():.3f}")
    check(finite, f"{label}: non-finite values")
    check(conv == 1.0 and infeas == 0.0, f"{label}: converged {conv}, infeasible {infeas}")
    if ref_lanes:
        ref = L.build_rollout(largem_mpc(k_hi, "cpu", torch.float64))(
            x0s[:ref_lanes], rs[:ref_lanes], None, N=N)
        us, us_ref = res.us[:ref_lanes].double().cpu(), ref.us
        rel_u = ((us - us_ref).abs() / (1.0 + us_ref.abs())).max().item()
        msg += f"; first {ref_lanes} lanes vs CPU f64 rollout: max rel |du| {rel_u:.3e}"
        check(rel_u <= 1e-5, f"{label} vs CPU f64: {rel_u:.3e} > 1e-5")
    log(msg)
    return rollout, x0s, rs, t_first


def host_ms(fn, reps: int) -> list:
    """Host-clock ms of each of ``reps`` calls of ``fn``, each ending in a
    synchronize (for paths that sync the host themselves)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def binary_offsets(mpc, U, lanes) -> float:
    """Max distance of a binary control to its nearer finite bound over
    the given lanes and every move of the horizon that is binary."""
    nu = mpc.model.nu
    U = U[lanes].reshape(int(lanes.sum()), -1, nu)
    n_bin = U.shape[1] if mpc.Nc_binary < 0 else mpc.Nc_binary
    worst = 0.0
    for b in mpc.binary_controls:
        u = U[:, :n_bin, b]
        off = np.full(u.shape, np.inf)
        for bound in (mpc.umin[b], mpc.umax[b]):
            if np.isfinite(bound):
                off = np.minimum(off, np.abs(u - bound))
        worst = max(worst, float(off.max()) if off.size else 0.0)
    return worst


def sync_sites(fn) -> list:
    """file:line of each synchronizing call that ``fn`` makes, from the
    sync debug mode "warn"."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def count_syncs(fn) -> int:
    """Synchronizing calls that ``fn`` makes, from the sync debug mode
    "warn" (which, by its own account, may miss some)."""
    return len(sync_sites(fn))


def compare_step(label, args, kw):
    """One recorded K3 step launch against ``step_iu_plain`` on the same
    inputs: no lane may differ anywhere (NaN where both are); returns the
    kernel's new state and max |dlam|."""
    st_k, _ = iu.step_iu(*args, **kw)
    st_p, _ = iu.step_iu_plain(*args, **kw)
    torch.cuda.synchronize()
    n_bad, n_float = equal_outputs(tuple(st_k), tuple(st_p))
    err = float(torch.nan_to_num((st_k.lam - st_p.lam).abs(), nan=0.0).max())
    entry = args[6]
    log(f"  {label}: B={args[2].shape[0]}, entering with {int((entry.pend >= 0).sum())} pending "
        f"rows, {int(entry.done.sum())} done, {int(args[4].sum(1).max())} eq rows at most; "
        f"disagreeing lanes {n_bad}, unequal float entries {n_float} (0 required), iterations "
        f"mean {st_k.iters.double().mean().item():.3f} max {int(st_k.iters.max())}")
    check(n_bad == 0, f"{label}: {n_bad} lanes differ from step_iu_plain")
    return st_k, err


def compare_search(label, fr, res_k, res_p, mpc):
    """K3's search entry (``res_k``) against the rounds (``res_p``: its
    plain version, or the rounds on K3's step entry), on the same lanes:
    every output of every lane equal (the management sums in the entry's
    order); after ``finish`` statuses equal,
    fval within 1e-6 (1 + |f|) and every binary on a bound (1e-5). Prints
    the lanes whose nodes, iterations or final working set differ and
    those that took a ray retry or hit the node limit; returns the entry's
    finished solution."""
    torch.cuda.synchronize()
    diff = torch.zeros(res_k.nodes.shape[0], dtype=torch.bool, device=res_k.nodes.device)
    for a, b in zip(res_k, res_p):
        d = a != b
        if a.dtype.is_floating_point:
            d &= ~(torch.isnan(a) & torch.isnan(b))
        diff |= d if d.dim() == 1 else d.any(1)
    n_trail = int(((res_k.nodes != res_p.nodes) | (res_k.iters != res_p.iters)).sum())
    ws = (res_k.inc_active != res_p.inc_active) | (res_k.inc_active & (res_k.inc_side
                                                                       != res_p.inc_side))
    sol_k, sol_p = fr.finish(res_k), fr.finish(res_p)
    st = sol_k.status.cpu().numpy()
    found = (st == 1) | (st == 2)
    f_k, f_p = sol_k.fval.double().cpu().numpy(), sol_p.fval.double().cpu().numpy()
    rel = float((np.abs(f_k - f_p) / (1.0 + np.abs(f_p)))[found].max()) if found.any() else 0.0
    off = binary_offsets(mpc, sol_k.U.double().cpu().numpy(), found)
    same_status = torch.equal(sol_k.status, sol_p.status)
    log(f"  search entry vs {label}: lanes with any output different "
        f"{int(diff.sum())} (0 required), with other nodes or iterations {n_trail}, with "
        f"another final working set {int(ws.any(1).sum())}; statuses equal {same_status}, "
        f"max rel |dfval| {rel:.3e}, binaries off their bound by {off:.3e} at most; lanes with "
        f"a ray retry {int((res_k.retries > 0).sum())}, at the node limit "
        f"{int((res_k.nodes >= fr.node_limit).sum())}")
    check(int(diff.sum()) == 0, f"search entry {label}: {int(diff.sum())} lanes differ from "
          f"the rounds")
    check(same_status, f"search entry {label}: statuses differ from the rounds")
    check(rel <= 1e-6, f"search entry {label}: fval vs the rounds {rel:.3e} > 1e-6")
    check(off <= 1e-5, f"search entry {label}: a binary control {off:.3e} off its bound")
    return sol_k


def lex_mpc(device, dtype=None):
    """The two-level lexicographic problem of bench.py:578-585 (m = 7):
    x >= 1 at priority 0 against x <= -1 at priority 1."""
    mpc = L.MPC.from_discrete([[1.0]], [[1.0]], C=[[1.0]], Np=3, Nc=3)
    mpc.set_bounds(umin=[-5.0], umax=[5.0])
    mpc.set_objective(Q=[1e-6], R=[1e-6])
    mpc.add_constraint(Ax=[[1.0]], lb=[1.0], ks=[2, 3], soft=True, prio=0)
    mpc.add_constraint(Ax=[[1.0]], ub=[-1.0], ks=[2, 3], soft=True, prio=1)
    mpc.settings.hierarchy = "lexicographic"
    return mpc.setup(device=device, dtype=dtype)


def hybrid_lex_phases(dev, by_path: dict) -> tuple[dict, float, dict]:
    """Phases [18]-[22]: the hybrid and lexicographic paths on the card,
    each with the counts set to 0 just before its run and read into
    ``by_path`` just after; returns the K3 step launch rows of [21], their
    max |dlam| against the plain step, and the K1 rows of the
    lexicographic levels' launches."""
    # [18] hybrid MPC: the satellite at its reference default (Np = Nc = 20,
    # m = 60, 40 binary rows), B = 512, theta in +-1 (bench.py:605-643),
    # through setup() with no device -- K3's search entry launched here, once
    # a batch
    mpc_h, _ = L.mpc_examples("satellite")
    mpc_h.setup()
    eng_h = mpc_h.engine
    check(eng_h.device.type == "cuda" and eng_h.dtype == torch.float32
          and eng_h.bnb_mode == "inc", f"satellite engine: {eng_h.device} {eng_h.dtype} "
          f"{getattr(eng_h, 'bnb_mode', None)}")
    n_bin = int(eng_h.ldp.is_binary.sum())
    log(f"[18] hybrid satellite m={eng_h.ldp.m}, {n_bin} binary rows, B={B_HYB}: the "
        f"incremental frontier in one launch of K3's search entry, {eng_h.stack_cap} stack "
        f"slots, node cap {eng_h.node_cap}")
    th_h = np.random.default_rng(18).uniform(-1.0, 1.0, (B_HYB, eng_h.ldp.n_theta))
    th_h_dev = torch.as_tensor(th_h, device=dev)
    reset_counts()
    sol_h = eng_h.solve_batch(th_h_dev)
    torch.cuda.synchronize()
    by_path["hybrid"] = read_counts()
    n_search, n_step = iu.SEARCH_LAUNCHES, iu.STEP_LAUNCHES
    check(sol_h.U.is_cuda, "hybrid: the solution is not on the card")
    st_h = sol_h.status.cpu().numpy()
    U_h = sol_h.U.double().cpu().numpy()
    found = (st_h == 1) | (st_h == 2)
    off = binary_offsets(mpc_h, U_h, found)
    ref_h = L.mpc_examples("satellite")[0].setup(device="cpu").engine.solve_batch(th_h[:HYB_REF])
    ok_ref = ref_h.status.numpy() == 1
    f_h, f_ref = sol_h.fval[:HYB_REF].double().cpu().numpy(), ref_h.fval.numpy()
    rel_f = float((np.abs(f_h - f_ref) / (1.0 + np.abs(f_ref)))[ok_ref].max()) if ok_ref.any() else 0.0
    same_ok = bool(np.array_equal(st_h[:HYB_REF] == 1, ok_ref))
    log(f"  status 1 {np.mean(st_h == 1):.6f}, 2 {np.mean(st_h == 2):.6f}, -2 "
        f"{np.mean(st_h == -2):.6f}, -1 {int(np.sum(st_h == -1))} lanes; K3 search entry "
        f"launches {n_search}, step launches {n_step} (K3 in all {by_path['hybrid']['iu']}); "
        f"binaries off their bound by {off:.3e} at most; first {HYB_REF} lanes vs the CPU "
        f"float64 frontier: status 1 on the same lanes {same_ok}, max rel |dfval| {rel_f:.3e}")
    check(n_search == 1 and n_step == 0,
          f"hybrid: {n_search} search entry launches and {n_step} step launches (1 and 0)")
    check(bool(np.all(st_h != -1)), "hybrid: a lane with status -1")
    check(bool(np.all(np.isfinite(U_h[found]))), "hybrid: non-finite controls")
    check(off <= 1e-5, f"hybrid: a binary control {off:.3e} off its bound")
    check(same_ok, "hybrid: status 1 on other lanes than the CPU float64 frontier")
    check(rel_f <= 1e-6, f"hybrid fval vs CPU f64: {rel_f:.3e} > 1e-6")
    plan = iu.last_plan("inc_search")
    log(f"  search entry launch plan at m={eng_h.ldp.m}, B={B_HYB}: {plan}")
    check(plan["team"] == 32, f"search entry at m=60 took the {plan['team']}-thread team")

    # the entry against its plain version, the search round by round on the
    # plain step (``step_iu_plain``) and the torch management, which sums in
    # the entry's order; its host-clock time is the entry's plain time
    fr = eng_h.inc_frontier()
    res_k = fr.search(th_h_dev)
    plain_ms = {}

    def plain_run(label, f_e, th_e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = f_e.search_plain(th_e)
        torch.cuda.synchronize()
        plain_ms[label] = 1e3 * (time.perf_counter() - t0)
        return res

    compare_search(f"its plain version, B={B_HYB}", fr, res_k,
                   plain_run(f"B={B_HYB}", fr, th_h_dev), mpc_h)

    # and against the same rounds on K3's step entry, which shares the
    # entry's GI loop, with the syncs of one round; the step launches
    # recorded for [21]
    held = [fr.init(th_h_dev), True]
    sync_round = None

    def one_round():  # a round and the loop test that follows it
        held[0] = fr.round(held[0])
        held[1] = fr.running(held[0])

    def all_rounds():
        nonlocal sync_round
        while held[1]:
            if fr.rounds == 10:
                sync_round = sync_sites(one_round)
            else:
                one_round()

    step_calls = record_calls(iu, "step_iu", all_rounds)
    res_p = iu.SearchResult(*(getattr(held[0], f) for f in iu.SearchResult._fields))
    n_rounds = fr.rounds
    compare_search(f"the rounds on K3's step, B={B_HYB}", fr, res_k, res_p, mpc_h)
    n_sync_search = count_syncs(lambda: fr.search(th_h_dev))
    log(f"  synchronizing calls: {n_sync_search} in the search entry's call (0 required), "
        f"{len(sync_round)} in one round and its loop test of the round-by-round run "
        f"({', '.join(sync_round)}), which made "
        f"{len(step_calls)} K3 step launches in {n_rounds} rounds")
    check(n_sync_search == 0, f"hybrid: the search entry's call made {n_sync_search} syncs")

    # the node limit starved at B = 64: status 2, held to the budget rule
    # against the unstarved search and bit for bit against its plain version
    fr_s = eng_h.inc_frontier()
    fr_s.node_limit = HYB_STARVED
    th_s = th_h_dev[:B_STARVED]
    starved = f"B={B_STARVED}, node limit {HYB_STARVED}"
    res_ks = fr_s.search(th_s)
    sol_ks = compare_search(f"its plain version, {starved}", fr_s, res_ks,
                            plain_run(starved, fr_s, th_s), mpc_h)
    st_s = sol_ks.status.cpu().numpy()
    f_s = sol_ks.fval.double().cpu().numpy()
    f_opt = sol_h.fval[:B_STARVED].double().cpu().numpy()
    tol = 1e-6 * (1.0 + np.abs(f_opt))
    n_one = int(np.sum(st_s == 1))
    bad_one = int(np.sum((np.abs(f_s - f_opt) > tol)[st_s == 1]))
    bad_two = int(np.sum((f_s < f_opt - tol)[st_s == 2]))
    log(f"  starved: status 1 on {n_one}, 2 on {int(np.sum(st_s == 2))} of {B_STARVED} lanes; "
        f"status-1 lanes off the unstarved optimum by more than 1e-6 (1 + |f|): {bad_one}; "
        f"status-2 lanes below it: {bad_two}")
    check(bool(np.all((st_s == 1) | (st_s == 2))), "starved hybrid: a lane not at status 1 or 2")
    check(bool(np.any(st_s == 2)), "starved hybrid: no lane at status 2")
    check(bad_one == 0 and bad_two == 0, "starved hybrid: the budget rule does not hold")

    # timings: the batch and single solves through the engine, the entry's
    # launch at B = 512 and B = 1 (CUDA events, the profiler's device time),
    # its plain version on the host clock (the runs above; B = 1 here), the
    # bound
    hyb_ms = host_ms(lambda: eng_h.solve_batch(th_h_dev), 5)
    lat_ms = [host_ms(lambda i=i: eng_h.solve(th_h[i]), 1)[0] for i in range(10)]
    prof_h = device_profile(f"hybrid batch of {B_HYB}",
                            lambda: eng_h.solve_batch(th_h_dev), 1, min(hyb_ms))
    card = card_line()
    log(f"  timings on {card}: batch {', '.join(f'{t:.1f}' for t in hyb_ms)} ms = "
        f"{B_HYB / min(hyb_ms) * 1e3:,.0f} B&B solves/s (best); single solve at B=1 "
        f"{', '.join(f'{t:.1f}' for t in lat_ms)} ms (median {np.median(lat_ms):.1f} ms; "
        f"Ts = 100 ms); mean iterations {res_k.iters.double().mean().item():.1f}, mean nodes "
        f"{res_k.nodes.double().mean().item():.1f}, slowest lane {int(res_k.rounds.max())} "
        f"rounds ({n_rounds} rounds round by round)")
    log(prof_h)
    entry_rows = {}
    fr1 = eng_h.inc_frontier()
    plain_run("B=1", fr1, th_h_dev[:1])
    for label, f_e, th_e in ((f"B={B_HYB}", fr, th_h_dev), ("B=1", fr1, th_h_dev[:1]),
                             (starved, fr_s, th_s)):
        res_e = f_e.search(th_e)
        ms = cuda_ms(lambda: f_e.search(th_e), 5)
        dev_ms = kernel_device_ms(lambda: f_e.search(th_e), "search_kernel")
        ms_p = plain_ms[label]
        b_ms, b_by = search_bound(f_e, res_e)
        log(f"  search entry {label}: call {ms:.4f} ms, device {fmt_ms(dev_ms)}, plain (the "
            f"rounds on the plain step) {ms_p:.1f} ms, bound {b_ms:.5f} ms ({b_by}); slowest lane "
            f"{int(res_e.iters.max())} iterations, {int(res_e.rounds.max())} rounds")
        entry_rows[f"search entry m={eng_h.ldp.m} {label}"] = dict(
            ms=ms, device_ms=dev_ms, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
            launches_per_batch=1)

    # [19] the closed-loop satellite (tests/test_hybrid.py:11-30) on the card
    N_CL = 20
    mpc_cl, _ = L.mpc_examples("satellite", 20)
    mpc_cl.settings.reference_preview = True
    mpc_cl.setup()
    rs_cl = np.vstack([np.hstack([np.zeros((1, 5)), 0.5 * np.ones((1, N_CL - 5))]),
                       np.zeros((2, N_CL))])
    F_cl, G_cl = np.asarray(mpc_cl.model.F), np.asarray(mpc_cl.model.G)
    t0 = time.perf_counter()
    sim = L.simulate_kw(mpc_cl, x0=np.zeros(3), N=N_CL, r=rs_cl,
                        dynamics=lambda x, u, d: F_cl @ x + G_cl @ np.atleast_1d(u))
    t_cl = time.perf_counter() - t0
    us = np.asarray(sim.us)
    on = all(np.all(np.isclose(us[b], mpc_cl.umin[b], atol=1e-5)
                    | np.isclose(us[b], mpc_cl.umax[b], atol=1e-5))
             for b in mpc_cl.binary_controls)
    y_end = float(sim.ys[0, -1])
    log(f"[19] closed-loop satellite, {N_CL} steps with reference preview on "
        f"{mpc_cl.engine.device}: y0 at the end {y_end:.6f} (0.5 within 1e-3), binaries on "
        f"their bounds {on}, {t_cl:.2f} s ({1e3 * t_cl / N_CL:.1f} ms a step)")
    check(mpc_cl.engine.device.type == "cuda", "closed loop: not on the card")
    check(abs(y_end - 0.5) < 1e-3, f"closed loop: y0 ends at {y_end}")
    check(on, "closed loop: a binary control off its bounds")

    # [20] the lexicographic hierarchy (bench.py:575-602): K1's float64
    # instantiation for each level -- K1's launches counted here
    mpc_x = lex_mpc(None)
    eng_x = mpc_x.engine
    check(eng_x.device.type == "cuda" and eng_x.path == "lex" and eng_x.ldp.m <= bulk.MAX_M,
          f"lex engine: {eng_x.device} {eng_x.path} m={eng_x.ldp.m}")
    th_x = np.random.default_rng(20).uniform(-2.0, 2.0, (B_LEX, eng_x.ldp.n_theta))
    th_x_dev = torch.as_tensor(th_x, device=dev)
    reset_counts()
    sol_x = eng_x.solve_batch(th_x_dev)
    torch.cuda.synchronize()
    by_path["lex"] = read_counts()
    ref_x = lex_mpc("cpu").engine.solve_batch(th_x[:LEX_REF])
    dU_x = (sol_x.U[:LEX_REF].cpu() - ref_x.U).abs().max().item()
    conv_x = (sol_x.status == 1).double().mean().item()
    lex_ms = cuda_ms(lambda: eng_x.solve_batch(th_x_dev), 10)
    prof_x = device_profile(f"lex batch of {B_LEX}",
                            lambda: [eng_x.solve_batch(th_x_dev) for _ in range(3)], 3, lex_ms)
    log(f"[20] lexicographic, {len(eng_x.lex.levels)} levels, m={eng_x.ldp.m}, B={B_LEX}: "
        f"status 1 {conv_x:.6f}, mean iterations {sol_x.iters.double().mean().item():.2f}, "
        f"K1 f64 launches {by_path['lex']['bulk']}; first {LEX_REF} lanes vs the CPU float64 "
        f"LexSolver: max |dU| {dU_x:.3e}, statuses equal "
        f"{torch.equal(sol_x.status[:LEX_REF].cpu(), ref_x.status)}; {lex_ms:.4f} ms a batch "
        f"= {B_LEX / lex_ms * 1e3:,.0f} solves/s on {card_line()}")
    log(prof_x)
    log("    the lexicographic path's K1 f64 launches, replayed: vs phase1_plain, call / "
        "device / plain time, bound")
    lex_calls = record_calls(bulk, "phase1", lambda: eng_x.solve_batch(th_x_dev))
    lex_rows = replay_small({f"K1 lexicographic level {i + 1} f64 B={B_LEX}": (bulk.phase1, a, k)
                             for i, (a, k) in enumerate(lex_calls)})["K1"]
    check(sol_x.U.is_cuda and sol_x.U.dtype == torch.float64, "lex: not float64 on the card")
    check(conv_x == 1.0, f"lex: status 1 on {conv_x} of the lanes")
    check(dU_x <= 1e-9, f"lex U vs CPU f64: {dU_x:.3e} > 1e-9")
    check(by_path["lex"]["bulk"] == len(eng_x.lex.levels),
          f"lex: {by_path['lex']['bulk']} K1 launches for {len(eng_x.lex.levels)} levels")

    # [21] the K3 step launches of [18]'s round-by-round run, replayed
    # alone: the first round, a mid-search round with pending rows and
    # branched eq rows, the last
    log("[21] K3 step launches of the hybrid path round by round: vs step_iu_plain, call / "
        "device / plain time, bound")
    n_eq = int(eng_h.ldp.is_eq.sum())
    n_step = len(step_calls)
    mid = next((i for i, (a, _k) in enumerate(step_calls)
                if int((a[6].pend >= 0).sum()) > 0 and int(a[4].sum(1).max()) > n_eq), None)
    check(mid is not None, "hybrid: no step launch entered with pending rows and branched eq")
    step_rows, k3_step_err = {}, 0.0
    for label, i in (("first round", 0), (f"round {mid + 1} (mid-search)", mid),
                     (f"round {len(step_calls)} (last)", len(step_calls) - 1)):
        a, k = step_calls[i]
        st_k, err = compare_step(f"K3 step, {label}", a, k)
        k3_step_err = max(k3_step_err, err)
        ms = cuda_ms(lambda: iu.step_iu(*a, **k), 20)
        dev_ms = kernel_device_ms(lambda: [iu.step_iu(*a, **k) for _ in range(5)], "iu_kernel")
        ms_p = cuda_ms(lambda: iu.step_iu_plain(*a, **k), 1, warmup=1)
        b_ms, b_by = step_bound(a, st_k)
        log(f"    call {ms:.4f} ms, device {fmt_ms(dev_ms)}, plain {ms_p:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by})")
        step_rows[f"step K=8 m={eng_h.ldp.m} B={B_HYB}, {label}"] = dict(
            ms=ms, device_ms=dev_ms, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
            launches_per_batch=n_step)
    return {**entry_rows, **step_rows}, k3_step_err, lex_rows


def contact_mpc(Np: int, device=None, dtype=None):
    """``invpend_contact`` at Np = Nc (m = 88 at 4, 142 at 6)."""
    mpc, _ = L.mpc_examples("invpend_contact", Np, Np)
    return mpc.setup(device=device, dtype=dtype)


def fixed_binary_gap(ldp, thetas, lam, fval) -> float:
    """Each lane's incumbent held against the float64 optimum of its binaries:
    every binary row fixed on the bound it is nearer (from the incumbent's
    multipliers ``lam``), the continuous QP re-solved by ``solve_ldp_numpy``.
    Fails on a lane whose re-solve is not optimal; returns the largest
    |fval - f_resolved| / (1 + |f_resolved|)."""
    b = np.asarray(ldp.is_binary)
    worst = 0.0
    for th, lm, f in zip(thetas, lam, fval):
        dt = ldp.Dth @ th
        c = ldp.G @ lm
        up = (np.where(ldp.up_finite, ldp.du + dt + c, np.inf)
              <= np.where(ldp.lo_finite, -(ldp.dl + dt) - c, np.inf))
        d = np.where(up, ldp.du, ldp.dl)
        fixed = dataclasses.replace(ldp, du=np.where(b, d, ldp.du), dl=np.where(b, d, ldp.dl),
                                    is_eq=np.asarray(ldp.is_eq) | b)
        U, *_rest, status = solve_ldp_numpy(fixed, th, max_iter=5000)
        check(status == 1, f"the fixed-binary QP of an incumbent: oracle status {status}")
        f_np = 0.5 * U @ ldp.H @ U + (ldp.f + ldp.f_theta @ th) @ U
        worst = max(worst, abs(f - f_np) / (1.0 + abs(f_np)))
    return worst


def contact_phases(dev, by_path: dict):
    """Phase [22]: float32 hybrid at m >= 67, the frontier rounds on the
    float64 node arrays (torch ops on the card: no kernel computes the
    masked-Cholesky scheme's loop), with the counts set to 0 just before the
    m = 88 run and read into ``by_path["contact"]`` just after; beside it the
    float64 engine's pop-per-round Cholesky frontier on the same lanes, then
    the JAX bench's contact shape (m = 142)."""
    mpc_k = contact_mpc(4)
    eng_k = mpc_k.engine
    fr = eng_k._rounds
    check(eng_k.device.type == "cuda" and eng_k.dtype == torch.float32
          and eng_k.bnb_mode == "rounds", f"contact engine: {eng_k.device} {eng_k.dtype} "
          f"{getattr(eng_k, 'bnb_mode', None)}")
    ldp_k = eng_k.ldp
    log(f"[22] invpend_contact Np=4 float32, m={ldp_k.m}, {int(ldp_k.is_binary.sum())} binary "
        f"rows, B={B_CONTACT}: the frontier rounds on the float64 node arrays, stack "
        f"{fr.stack_cap} slots, node cap {fr.node_cap}, {fr.K_CHUNK} iterations a round, a "
        f"poll every {fr.POLL_EVERY} rounds")
    th_k = np.random.default_rng(3).uniform(-0.3, 0.3, (B_CONTACT, ldp_k.n_theta))
    th_k_dev = torch.as_tensor(th_k, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    sol_k = eng_k.solve_batch(th_k_dev)
    torch.cuda.synchronize()
    t_counted = 1e3 * (time.perf_counter() - t0)
    by_path["contact"] = read_counts()
    s_k, rounds_k = fr.last_state, fr.rounds
    st_k = sol_k.status.cpu().numpy()
    U_k = sol_k.U.double().cpu().numpy()
    found = (st_k == 1) | (st_k == 2)
    off = binary_offsets(mpc_k, U_k, found)
    t0 = time.perf_counter()
    ref_k = contact_mpc(4, "cpu", torch.float64).engine.solve_batch(th_k[:CONTACT_REF])
    t_ref = time.perf_counter() - t0
    ok_ref = ref_k.status.numpy() == 1
    f_k, f_ref = sol_k.fval[:CONTACT_REF].double().cpu().numpy(), ref_k.fval.numpy()
    rel_f = float((np.abs(f_k - f_ref) / (1.0 + np.abs(f_ref)))[ok_ref].max()) if ok_ref.any() else 0.0
    same_ok = bool(np.array_equal(st_k[:CONTACT_REF] == 1, ok_ref))
    log(f"  status 1 {np.mean(st_k == 1):.6f}, 2 {np.mean(st_k == 2):.6f}, -2 "
        f"{np.mean(st_k == -2):.6f}, -1 {int(np.sum(st_k == -1))} lanes; {rounds_k} rounds, "
        f"reseeds a lane mean {s_k.reseeds.double().mean().item():.1f} max "
        f"{int(s_k.reseeds.max())}; binaries off their bound "
        f"by {off:.3e} at most; first {CONTACT_REF} lanes vs the CPU float64 frontier "
        f"({t_ref:.1f} s on the host): status 1 on the same lanes {same_ok}, max rel |dfval| "
        f"{rel_f:.3e}; kernel launches {by_path['contact']} (none computes this loop)")
    check(sol_k.U.is_cuda, "contact: the solution is not on the card")
    check(bool(np.all(st_k != -1)), "contact: a lane with status -1")
    check(bool(np.all(np.isfinite(U_k[found]))), "contact: non-finite controls")
    check(off <= 1e-5, f"contact: a binary control {off:.3e} off its bound")
    check(same_ok, "contact: status 1 on other lanes than the CPU float64 frontier")
    check(rel_f <= 1e-6, f"contact fval vs CPU f64: {rel_f:.3e} > 1e-6")

    # the host syncs of one poll (its rounds and the test that ends it), mid-search
    held = [fr.init(th_k_dev)]

    def rounds(n):
        for _ in range(n):
            held[0], any_active = fr.step(held[0])
        return any_active

    rounds(40)
    n_sync = count_syncs(lambda: bool(rounds(fr.POLL_EVERY)))
    check(n_sync == 1, f"contact: {n_sync} synchronizing calls in one poll, 1 expected")
    # one timed batch: a second would add a minute of host time to the run
    ms_round = t_counted / rounds_k
    prof_k = "\n".join((
        device_profile(f"contact, {fr.POLL_EVERY} rounds mid-search",
                       lambda: rounds(fr.POLL_EVERY), fr.POLL_EVERY, ms_round),
        host_profile(f"contact, {fr.POLL_EVERY} rounds mid-search",
                     lambda: rounds(fr.POLL_EVERY), fr.POLL_EVERY)))
    log(f"  timings on {card_line()}: batch {t_counted:.1f} ms (the counted run) = "
        f"{B_CONTACT / t_counted * 1e3:,.2f} B&B solves/s, {ms_round:.3f} ms a round; "
        f"mean iterations {sol_k.iters.double().mean().item():.1f}, mean nodes "
        f"{s_k.nodes.double().mean().item():.1f}; {n_sync} synchronizing call in one poll of "
        f"{fr.POLL_EVERY} rounds")
    log(prof_k)

    # the float64 engine on the same lanes: the pop-per-round frontier with
    # the masked-Cholesky relax, its rounds counted at the relax
    eng_64 = contact_mpc(4, "cuda", torch.float64).engine
    check(eng_64.bnb_mode == "frontier", f"contact f64 engine: {eng_64.bnb_mode}")
    relax, n_relax = eng_64._relax, [0]

    def counted(*a):
        n_relax[0] += 1
        return relax(*a)

    eng_64._relax = counted
    res_64 = []
    ms_64 = host_ms(lambda: res_64.append(eng_64.solve_batch(th_k_dev)), 1)[0]
    eng_64._relax = relax
    st_64 = res_64[0].status[:CONTACT_REF].cpu()
    f_64 = res_64[0].fval[:CONTACT_REF].cpu().numpy()
    rel_64 = float((np.abs(f_64 - f_ref) / (1.0 + np.abs(f_ref)))[ok_ref].max()) if ok_ref.any() else 0.0
    log(f"  float64 engine, pop-per-round frontier with the Cholesky relax, same {B_CONTACT} "
        f"lanes on the card: {ms_64:.1f} ms a batch, {n_relax[0]} rounds, "
        f"{ms_64 / n_relax[0]:.3f} ms a round, status 1 "
        f"{(res_64[0].status == 1).double().mean().item():.6f}; first {CONTACT_REF} lanes "
        f"statuses equal to the CPU {torch.equal(st_64, ref_k.status)}, max rel |dfval| "
        f"{rel_64:.3e}")
    check(torch.equal(st_64, ref_k.status), "contact f64 on the card: statuses")
    check(rel_64 <= 1e-6, f"contact f64 on the card: fval {rel_64:.3e} off the CPU")

    # the JAX bench's own contact shape (bench.py:755-760): Np = Nc = 6
    mpc_b = contact_mpc(6)
    eng_b = mpc_b.engine
    check(eng_b.bnb_mode == "rounds", f"m=142 engine: {eng_b.bnb_mode}")
    th_b = np.random.default_rng(7).uniform(-0.3, 0.3, (B_BENCH_CONTACT, eng_b.ldp.n_theta))
    t0 = time.perf_counter()
    sol_b = eng_b.solve_batch(torch.as_tensor(th_b, device=dev))
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    st_b = sol_b.status.cpu().numpy()
    found_b = (st_b == 1) | (st_b == 2)
    check(bool(np.all(found_b)), f"m=142: lanes without an incumbent, statuses {st_b}")
    gap_b = fixed_binary_gap(eng_b.ldp, th_b, sol_b.lam.cpu().numpy(), sol_b.fval.cpu().numpy())
    log(f"  the JAX bench's shape, invpend_contact Np=6 float32, m={eng_b.ldp.m}, "
        f"{int(eng_b.ldp.is_binary.sum())} binary rows, B={B_BENCH_CONTACT}: status 1 "
        f"{np.mean(st_b == 1):.4f}, 2 {np.mean(st_b == 2):.4f}, mean iterations "
        f"{sol_b.iters.double().mean().item():.0f}, {eng_b._rounds.rounds} rounds, {t_b:.2f} s = "
        f"{B_BENCH_CONTACT / t_b:,.3f} B&B solves/s on {card_line()}; each incumbent vs the "
        f"float64 re-solve of its fixed-binary QP: max rel |dfval| {gap_b:.3e}")
    check(gap_b <= 1e-6, f"m=142: an incumbent {gap_b:.3e} off its fixed-binary optimum")


def lp_infeasible(mpc, theta) -> bool:
    """Whether no U meets bl + W theta <= [I; A] U <= bu + W theta: a
    linear program with a zero objective (HiGHS) reports it infeasible."""
    from scipy.optimize import linprog

    q = mpc.mpQP
    E = q.extended_A()
    up, lo = q.bu + q.W @ theta, q.bl + q.W @ theta
    fu, fl = np.isfinite(up), np.isfinite(lo)
    res = linprog(np.zeros(E.shape[1]), A_ub=np.vstack([E[fu], -E[fl]]),
                  b_ub=np.hstack([up[fu], -lo[fl]]), bounds=(None, None), method="highs")
    return res.status == 2


def double_integrator(device, dtype):
    """A double integrator with no constraint: m = 0."""
    mpc = L.MPC.from_discrete([[1.0, 0.1], [0.0, 1.0]], [[0.0], [1.0]], C=np.eye(2), Np=5, Nc=3)
    mpc.set_objective(Q=[1.0, 1.0], R=[0.1])
    return mpc.setup(device=device, dtype=dtype)


def game_mpc(binary: bool, device, dtype):
    """Two players with their own objectives (a non-symmetric H,
    tests/test_torch_hybrid.py's game MPC), player 0's control binary or not."""
    mpc = L.MPC.from_discrete([[1.0, 0.1], [0, 1]], [[0.0, 0], [1, 1]], C=np.eye(2), Np=3)
    mpc.set_objective(uids=[0], Q=[1, 0], Rr=1e3 * np.eye(1))
    mpc.set_objective(uids=[1], Q=[0, 1], Rr=1e3 * np.eye(1))
    mpc.set_bounds(umin=[0.0, -1.0], umax=[1.0, 1.0])
    if binary:
        mpc.set_binary_controls([0])
    return mpc.setup(device=device, dtype=dtype)


def single_phases(dev, by_path: dict) -> tuple[dict, dict]:
    """Phase [23]: single solves through ``solve_single`` (the golden point,
    an infeasible one, float32 at m = 11 and m = 0), then the engine paths
    it opened beside them: the float64 engine on the card and a
    non-symmetric H in float32. The counts are set to 0 just before each of
    the three and read just after, into ``by_path["single"]``,
    ``by_path["exact"]`` and ``by_path["nonsym"]``; then the K1 and K3
    launches of the single solves are replayed against their plain
    versions. Returns the replayed rows of K1 and K3."""
    rng = np.random.default_rng(23)
    reset_counts()
    # the golden single solve: K1 f32 bulk phase, K1 f64 continuation
    mpc, _ = L.mpc_examples("invpend")
    mpc.setup()
    eng = mpc.engine
    k1_u = []
    k1_calls = record_calls(bulk, "phase1",
                            lambda: k1_u.append(mpc.compute_control([5.0, 5.0, 0.0, 0.0])))
    u = k1_u[0]
    dts = sorted(str(a[2].dtype)[6:] for a, _k in k1_calls)
    log(f"[23] single solves: golden u = {u[0]:.10f} through solve_single, K1 launches "
        f"{', '.join(dts)}")
    check(abs(u[0] - GOLDEN_U) <= 1e-6, f"solve_single golden u {u[0]}")
    check(dts == ["float32", "float64"], f"golden single solve: K1 launches {dts}")

    # an infeasible point of the m = 48 problem: K3 bulk phase, float64
    # continuation. The NumPy oracle reports 1 or -1 only (no infeasibility
    # certificate), so a linear program certifies the point
    mpc_iu = largem_mpc(12, dev, torch.float32)
    ths = largem_thetas(rng, 64, 12.0)
    th_x = next(t for t in ths if lp_infeasible(mpc_iu, t))
    res = []
    k3_calls = record_calls(iu, "phase1_iu", lambda: res.append(mpc_iu.solve(th_x)))
    U_x, _f, st_x, _info = res[0]
    log(f"  infeasible point at m={mpc_iu.engine.ldp.m} (no U meets the constraints: HiGHS; "
        f"the NumPy oracle's status {solve_ldp_numpy(mpc_iu.engine.ldp, th_x)[-1]}): MPC.solve "
        f"status {st_x}, controls finite {bool(np.isfinite(U_x).all())}, K3 launches "
        f"{len(k3_calls)}")
    check(st_x == -3 and np.isfinite(U_x).all(), f"infeasible single solve: status {st_x}")
    check(len(k3_calls) == 1, f"infeasible single solve: {len(k3_calls)} K3 launches")

    # float32 at m = 11 (batched solve_single: no kernel computes its loop)
    case11 = ("invpend", 50, 11)
    mpc11, _ = L.mpc_examples(*case11)
    eng11 = mpc11.setup().engine
    th11 = sample_thetas(case11, rng, 256)
    sol11 = eng11.solve_batch(torch.as_tensor(th11, device=dev))
    e11, wrong11, dec11 = oracle_error(eng11.ldp, th11, sol11.U.cpu().numpy(),
                                       sol11.status.cpu().numpy())
    log(f"  float32 m={eng11.ldp.m} ({eng11.path}), B=256: {status_line(sol11)}; max |U - "
        f"U_oracle| {e11:.3e}, {wrong11} of {dec11} oracle verdicts contradicted")
    check(eng11.path == "single" and e11 <= 1e-9 and wrong11 == 0, f"m=11: error {e11:.3e}")

    # float32 at m = 0: the closed form
    eng0 = double_integrator(None, torch.float32).engine
    th0 = rng.uniform(-1.0, 1.0, (256, eng0.ldp.n_theta))
    sol0 = eng0.solve_batch(torch.as_tensor(th0, device=dev))
    U0_np = th0 @ eng0.ldp.Uth_off.T + eng0.ldp.u_off
    e0 = float(np.abs(sol0.U.cpu().numpy() - U0_np).max())
    log(f"  float32 m={eng0.ldp.m} ({eng0.path}), B=256: status 1 "
        f"{(sol0.status == 1).double().mean().item():.6f}, max |U - U_closed_form| {e0:.3e}")
    check(bool((sol0.status == 1).all()) and e0 <= 1e-9, f"m=0: error {e0:.3e}")
    torch.cuda.synchronize()
    by_path["single"] = read_counts()
    log(f"    single-solve path launches: {by_path['single']}")
    check(by_path["single"] == dict(bulk=len(k1_calls), polish=0, iu=len(k3_calls), ciu=0,
                                    iu_epilogue=0, roll_finish=0, roll_finish_merge=0),
          "single solves: launches other than the golden solve's K1 and the infeasible "
          "point's K3")

    # the float64 engine on the card: invpend (K1 f64) and the m = 48 box
    # problem (the masked Cholesky loop as torch ops)
    reset_counts()
    for label, mk, B, n_ref in (
            ("invpend", lambda: L.mpc_examples("invpend")[0].setup(device=dev, dtype=torch.float64),
             4096, N_ORACLE),
            ("the m=48 box", lambda: largem_mpc(12, dev, torch.float64), 256, 256)):
        mpc64 = mk()
        eng64 = mpc64.engine
        th64 = (sample_thetas(("invpend", None, None), rng, B) if label == "invpend"
                else largem_thetas(rng, B, 12.0))
        k1_before = bulk.LAUNCHES
        sol64 = eng64.solve_batch(torch.as_tensor(th64, device=dev))
        e64, wrong64, dec64 = oracle_error(eng64.ldp, th64[:n_ref], sol64.U[:n_ref].cpu().numpy(),
                                           sol64.status[:n_ref].cpu().numpy())
        log(f"  float64 engine on the card, {label} (m={eng64.ldp.m}, {eng64.path}), B={B}: "
            f"{status_line(sol64)}; over {n_ref} lanes max |U - U_oracle| {e64:.3e}, {wrong64} of "
            f"{dec64} oracle verdicts contradicted; K1 f64 launches +{bulk.LAUNCHES - k1_before}")
        check(sol64.U.is_cuda and sol64.U.dtype == torch.float64, f"f64 {label}: not on the card")
        check(bool((sol64.status != -1).all()), f"f64 {label}: a lane with status -1")
        check(e64 <= 1e-9 and wrong64 == 0, f"f64 {label}: error {e64:.3e}, {wrong64} verdicts")
        check((bulk.LAUNCHES > k1_before) == (eng64.ldp.m <= bulk.MAX_M),
              f"f64 {label}: K1 launches")

    torch.cuda.synchronize()
    by_path["exact"] = read_counts()
    log(f"    float64 engine launches: {by_path['exact']}")
    check(by_path["exact"]["bulk"] > 0, "float64 engine: K1 f64 was never launched")

    # a non-symmetric H in float32, without and with its binary control,
    # against the port's CPU float64 engine
    reset_counts()
    for binary in (False, True):
        mpc_g = game_mpc(binary, None, torch.float32)
        eng_g = mpc_g.engine
        th_g = np.stack([mpc_g.form_parameter(rng.uniform(-2, 2, 2), r=rng.uniform(-1, 1, 2))
                         for _ in range(64)])
        sol_g = eng_g.solve_batch(torch.as_tensor(th_g, device=dev))
        ref_g = game_mpc(binary, "cpu", torch.float64).engine.solve_batch(th_g)
        dU_g = (sol_g.U.double().cpu() - ref_g.U).abs().max().item()
        tol = 1e-7 if binary else 1e-9
        log(f"  non-symmetric H float32{' with a binary control' if binary else ''} "
            f"({eng_g.path}{', ' + eng_g.bnb_mode if binary else ''}), B=64: status 1 "
            f"{(sol_g.status == 1).double().mean().item():.6f}, vs the CPU float64 engine: "
            f"statuses equal {torch.equal(sol_g.status.cpu(), ref_g.status)}, max |dU| {dU_g:.3e}")
        check(torch.equal(sol_g.status.cpu(), ref_g.status) and dU_g <= tol,
              f"non-symmetric H (binary {binary}): |dU| {dU_g:.3e}")
    torch.cuda.synchronize()
    by_path["nonsym"] = read_counts()
    log(f"    non-symmetric H launches: {by_path['nonsym']}")
    check(by_path["nonsym"]["bulk"] > 0 and by_path["nonsym"]["polish"] > 0,
          "non-symmetric H: the small-m tier's K1 or K2 was never launched")

    # the B = 1 latency of compute_control: solve_single against the tier
    # at B = 1 (the route of single solves before)
    x0 = [5.0, 5.0, 0.0, 0.0]
    th1 = torch.as_tensor(mpc.form_parameter(np.array(x0))[None], device=dev)
    lat_single = host_ms(lambda: mpc.compute_control(x0), 20)
    lat_tier = host_ms(lambda: eng.solve_batch(th1), 20)
    log(f"  B=1 latency on {card_line()}: compute_control through solve_single median "
        f"{np.median(lat_single):.3f} ms (min {min(lat_single):.3f}); the tier at B=1 median "
        f"{np.median(lat_tier):.3f} ms (min {min(lat_tier):.3f})")

    log("    the single solves' K1 and K3 launches, replayed: vs plain, call / device / plain "
        "time, bound")
    k1_rows = replay_small({f"K1 single solve {str(a[2].dtype)[6:]} B=1": (bulk.phase1, a, k)
                            for a, k in k1_calls})["K1"]
    k3_rows = replay_launches({"K3 single solve f32 B=1": (iu.phase1_iu, *k3_calls[0])})
    return k1_rows, k3_rows


def unmeasured_phases(dev):
    """Phase [24], two numbers of the port never measured on the card: the
    small-m tier's converged fraction on aircraft at its full range (x, d in
    +-20), and the lexicographic path past K1's table (m = 13, each level
    the plain float64 loop as torch ops) against the CPU ``LexSolver``."""
    case = ("aircraft", None, None)
    mpc_a, _ = L.mpc_examples(*case)
    eng_a = mpc_a.setup().engine
    th_a = sample_thetas(case, np.random.default_rng(24), B_COLD)
    sol_a = eng_a.solve_batch(torch.as_tensor(th_a, device=dev))
    st_a = sol_a.status[:N_ORACLE].cpu().numpy()
    U_a = sol_a.U[:N_ORACLE].cpu().numpy()
    oracle = [solve_ldp_numpy(eng_a.ldp, t) for t in th_a[:N_ORACLE]]
    both = [i for i, o in enumerate(oracle) if o[-1] == 1 and st_a[i] == 1]
    e_a = max((float(np.abs(U_a[i] - oracle[i][0]).max()) for i in both), default=0.0)
    log(f"[24] aircraft tier (m={eng_a.ldp.m}, {eng_a.path}) at its full range, B={B_COLD}: "
        f"{status_line(sol_a)}, mean iterations {sol_a.iters.double().mean().item():.2f}; of "
        f"the first {N_ORACLE} lanes the oracle solves {sum(o[-1] == 1 for o in oracle)}, the "
        f"tier {int((st_a == 1).sum())}, both {len(both)}: max |U - U_oracle| there {e_a:.3e}")
    check(bool(torch.isfinite(sol_a.U[sol_a.status == 1]).all()), "aircraft: non-finite controls")

    def lex13(device):
        mpc = L.MPC.from_discrete([[1.0]], [[1.0]], C=[[1.0]], Np=5, Nc=5)
        mpc.set_bounds(umin=[-5.0], umax=[5.0])
        mpc.set_objective(Q=[1e-6], R=[1e-6])
        mpc.add_constraint(Ax=[[1.0]], lb=[1.0], ks=range(2, 6), soft=True, prio=0)
        mpc.add_constraint(Ax=[[1.0]], ub=[-1.0], ks=range(2, 6), soft=True, prio=1)
        mpc.settings.hierarchy = "lexicographic"
        return mpc.setup(device=device).engine

    eng_l, ref_l = lex13(None), lex13("cpu")
    check(eng_l.path == "lex" and eng_l.ldp.m > bulk.MAX_M, f"lex m={eng_l.ldp.m}")
    th_l = np.random.default_rng(34).uniform(-2.0, 2.0, (1024, eng_l.ldp.n_theta))
    th_l_dev = torch.as_tensor(th_l, device=dev)
    k1_before = bulk.LAUNCHES
    sol_l = eng_l.solve_batch(th_l_dev)
    sol_r = ref_l.solve_batch(th_l)
    dU_l = (sol_l.U.cpu() - sol_r.U).abs().max().item()
    ms_l = host_ms(lambda: eng_l.solve_batch(th_l_dev), 3)
    ms_r = host_ms(lambda: ref_l.solve_batch(th_l), 3)
    log(f"  lexicographic m={eng_l.ldp.m}, {len(eng_l.lex.levels)} levels, B=1024 on "
        f"{card_line()}: status 1 {(sol_l.status == 1).double().mean().item():.6f}, vs the CPU "
        f"LexSolver: statuses equal {torch.equal(sol_l.status.cpu(), sol_r.status)}, max |dU| "
        f"{dU_l:.3e}; {min(ms_l):.3f} ms a batch on the card, {min(ms_r):.3f} ms on the host; "
        f"K1 launches +{bulk.LAUNCHES - k1_before}")
    # its weights (1e-6 against soft weights 1e6) put U's round-off floor
    # near 1e-9: the card's cuSOLVER and the host's LAPACK differ there
    check(torch.equal(sol_l.status.cpu(), sol_r.status) and dU_l <= 1e-8,
          f"lex m=13 vs CPU: |dU| {dU_l:.3e}")


def oracle_lanes(B, m=24, nth=7, seed=0):
    """``tests/test_lp_oracle.py``'s Chebyshev instances: normalized random
    rows, mixed feasible and empty, box +-10."""
    rng = np.random.default_rng(seed)
    As, bs = np.zeros((B, m, nth)), np.ones((B, m))
    for i in range(B):
        k = rng.integers(5, m)
        A = rng.standard_normal((k, nth))
        A /= np.linalg.norm(A, axis=1, keepdims=True)
        bs[i, :k] = A @ rng.uniform(-5, 5, nth) + rng.uniform(-0.5, 2.0, k)
        As[i, :k] = A
    return As, bs, -10 * np.ones(nth), 10 * np.ones(nth)


def launches_of(fn) -> int:
    """Kernel launches ``fn`` makes (the launch calls the profiler records:
    cudaLaunchKernel, cuLaunchKernel and their variants)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)


def device_busy_ms(fn) -> float:
    """Device kernel time of one call of ``fn`` from torch.profiler (0.0
    where the profiler recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA) / 1e3


def lp_oracle_phase(dev):
    """Phase [25]: the batched float64 interior-point LP oracle on the card,
    1024 Chebyshev lanes against the same function on the CPU and against
    HiGHS on the converged lanes; then the profile of one IPM iteration and
    the time of one chunk."""
    from linearmpc_tpu_torch.explicit import _chebyshev_radius
    from linearmpc_tpu_torch.ops import lp_ipm

    t_phase = time.perf_counter()
    As, bs, lb, ub = oracle_lanes(B_LP)
    stats = {}
    r, _cen, gap = lp_ipm.chebyshev_batch(As, bs, lb, ub, stats=stats)
    r_c, _cen_c, gap_c = lp_ipm.chebyshev_batch(As, bs, lb, ub, device="cpu")
    conv = (gap <= 1e-9) & (gap_c <= 1e-9)
    d_cpu = float(np.max(np.abs(r - r_c)[conv])) if conv.any() else 0.0
    d_highs, sign_ok = 0.0, True
    for i in np.where(gap <= 1e-9)[0]:
        A = As[i][np.abs(As[i]).sum(1) > 0]
        r_h, _c_h = _chebyshev_radius(A, bs[i][: len(A)], lb, ub)  # -inf: empty
        sign_ok &= bool((r[i] > 1e-7) == (r_h > 1e-7))
        if np.isfinite(r_h):
            d_highs = max(d_highs, abs(r[i] - r_h))
    log(f"[25] LP oracle on the card: chebyshev_batch, {B_LP} lanes (m=24, nth=7, seed 0), "
        f"{stats}: {int(np.sum(gap <= 1e-9))} converged lanes (gap <= 1e-9); vs the CPU "
        f"run: verdicts equal {bool(np.array_equal(r > 0, r_c > 0))}, max |dr| {d_cpu:.3e} "
        f"on lanes converged in both; vs HiGHS: max |r - r_HiGHS| {d_highs:.3e}, signs "
        f"agree {sign_ok}")
    check(stats == {"ipm_chunks": 1, "ipm_lanes": B_LP}, f"LP oracle: {stats}")
    check(np.array_equal(r > 0, r_c > 0), "LP oracle: a verdict differs from the CPU run")
    check(d_cpu <= 1e-9, f"LP oracle vs CPU: |dr| {d_cpu:.3e} > 1e-9")
    check(d_highs <= 1e-7 and sign_ok, f"LP oracle vs HiGHS: |dr| {d_highs:.3e}, signs {sign_ok}")
    check(int(np.sum(gap <= 1e-9)) >= B_LP * 9 // 10, "LP oracle: fewer than 90% converged")

    # one chunk's IPM on the card: its launches an iteration, QR's share,
    # its host syncs, its time
    A, b, c, x0 = (torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)
                   for a in lp_ipm.chebyshev_lp(As, bs, lb, ub))
    ipm = lambda n: lp_ipm.lp_ipm_batch(A, b, c, x0, n_iter=n)
    per_iter = launches_of(lambda: ipm(2)) - launches_of(lambda: ipm(1))
    sites_1, sites_45 = sync_sites(lambda: ipm(1)), sync_sites(lambda: ipm(45))
    ms_45, ms_1 = cuda_ms(lambda: ipm(45), 5), cuda_ms(lambda: ipm(1), 20)
    ms_iter = (ms_45 - ms_1) / 44
    n = A.shape[2]
    W = torch.cat([A, torch.eye(n, dtype=A.dtype, device=dev).expand(A.shape[0], n, n)], 1)
    ms_qr = cuda_ms(lambda: torch.linalg.qr(W, mode="r"), 20)
    qr_launches = launches_of(lambda: torch.linalg.qr(W, mode="r"))
    busy = device_busy_ms(lambda: ipm(45))
    ms_chunk = float(np.median(host_ms(
        lambda: lp_ipm.chebyshev_batch(As, bs, lb, ub, device=dev), 5)))
    # the bound of one chunk: its inputs and outputs once, and per
    # iteration the QR of the (m + n) x n matrix (2 m n^2 flops) and the
    # products with A (about 8 m n), in float64
    Bc, m = A.shape[0], A.shape[1]
    flops = 45 * Bc * (2 * (m + n) * n * n + 8 * m * n)
    bnd = bound(nbytes(A, b, c, x0) + 8 * Bc * (2 * n + 2), flops, torch.float64)
    log(f"    one IPM chunk, B={Bc}, {m} x {n} rows (45 iterations): {per_iter} kernel launches "
        f"an iteration ({qr_launches} of them the QR); {ms_iter:.3f} ms an iteration, the QR "
        f"alone {ms_qr:.3f} ms ({100 * ms_qr / ms_iter:.1f}%); lp_ipm_batch {ms_45:.3f} ms, "
        f"device kernels {busy:.3f} ms of it (busy {100 * busy / ms_45:.1f}%); "
        f"chebyshev_batch with its host assembly and copies {ms_chunk:.3f} ms; bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}); synchronizing calls in lp_ipm_batch: {len(sites_1)} "
        f"at 1 iteration, {len(sites_45)} at 45 ({', '.join(sites_45) or 'none'}); "
        f"on {card_line()}")
    check(len(sites_45) == len(sites_1), "lp_ipm_batch syncs the host inside its loop")
    log(f"    [25] {time.perf_counter() - t_phase:.1f} s")


def explicit_thetas(mpc, prange, rng, B):
    """theta as ``tests/test_explicit.py:43-60`` draws it for invpend: the
    inner 75% of the range in x, r, d and p, u_prev over its whole range."""
    lo, hi = prange.lower(), prange.upper()
    nx, nr, nd, nuprev, _np = mpc.get_parameter_dims()
    scale = np.full(len(lo), 0.75)
    scale[nx + nr + nd: nx + nr + nd + nuprev] = 1.0
    return (lo + hi) / 2 + scale * (hi - lo) / 2 * rng.uniform(-1.0, 1.0, (B, len(lo)))


def explicit_phase(dev):
    """Phase [26]: explicit MPC for invpend and ballplate at their default
    ranges with the LP oracle on the card (through setup() with no device),
    held against the host (HiGHS) enumeration; batched point location at
    B = 32768 against host ``evaluate`` and the float64 implicit engine on
    the card; the BST on invpend; a checkpoint round trip."""
    t_phase = time.perf_counter()
    for name, n_regions in (("invpend", 93), ("ballplate", 275)):
        mpc, prange = L.mpc_examples(name)
        mpc.setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        empc = L.build_explicit(mpc, prange=prange)
        t_enum = time.perf_counter() - t0
        t0 = time.perf_counter()
        e_host = L.build_explicit(mpc, prange=prange, oracle="host")
        t_host = time.perf_counter() - t0
        sets = sorted(cr.active_set for cr in empc.regions)
        same = sets == sorted(cr.active_set for cr in e_host.regions)
        st = empc.stats
        log(f"[26] explicit {name} (nth={empc.nth}): {len(sets)} regions, the same active sets "
            f"as the HiGHS enumeration {same}; enumeration {t_enum:.2f} s with the oracle on "
            f"{empc.device}: {st['ipm_chunks']} IPM chunks, {st['ipm_lanes']} lanes, "
            f"{st['highs']} lanes confirmed by HiGHS; HiGHS enumeration {t_host:.2f} s "
            f"({e_host.stats['highs']} LPs)")
        check(empc.device.type == "cuda" and st["ipm_chunks"] > 0, f"{name}: oracle not on the card")
        check(len(sets) == n_regions, f"{name}: {len(sets)} regions, {n_regions} expected")
        check(same, f"{name}: active sets differ from the HiGHS enumeration")

        th = explicit_thetas(mpc, prange, np.random.default_rng(6), B_EVAL)
        th_dev = torch.as_tensor(th, device=dev)
        u, viol = empc.evaluate_batch(th_dev)
        check(u.is_cuda and u.dtype == torch.float64 and u.shape == (B_EVAL, empc.nu),
              f"{name}: evaluate_batch gave {u.device} {u.dtype} {tuple(u.shape)}")
        ms_eval = cuda_ms(lambda: empc.evaluate_batch(th_dev), 10)
        u_h, viol_h = u[:N_ORACLE].cpu().numpy(), viol[:N_ORACLE].cpu().numpy()
        inside = np.where(viol_h < 1e-8)[0]
        d_host = max((float(np.max(np.abs(u_h[i] - empc.evaluate(th[i])))) for i in inside),
                     default=0.0)
        m64, _ = L.mpc_examples(name)
        m64.setup(device=dev, dtype=torch.float64)
        sol = m64.engine.solve_batch(th_dev[:N_ORACLE])
        U, st64 = sol.U.cpu().numpy(), sol.status.cpu().numpy()
        nu, nx = m64.model.nu, m64.model.nx
        u_imp = U[:, :nu] - th[:N_ORACLE, :nx] @ m64.K.T
        both = (viol_h < 1e-8) & (st64 == 1)
        d_imp = float(np.max(np.abs(u_h - u_imp)[both])) if both.any() else 0.0
        log(f"    evaluate_batch B={B_EVAL} float64: {ms_eval:.3f} ms = "
            f"{B_EVAL / ms_eval * 1e3:,.0f} evaluations/s; {int(np.sum(viol.cpu().numpy() < 1e-8))} "
            f"lanes inside a region; first {N_ORACLE}: vs host evaluate max |du| {d_host:.3e} on "
            f"{len(inside)} lanes, vs the float64 implicit engine on the card ({m64.engine.path}) "
            f"{d_imp:.3e} on {int(both.sum())} lanes; on {card_line()}")
        check(len(inside) >= N_ORACLE // 2, f"{name}: {len(inside)} of {N_ORACLE} lanes inside")
        check(d_host <= 1e-9, f"{name}: evaluate_batch vs evaluate {d_host:.3e} > 1e-9")
        check(int(both.sum()) >= N_ORACLE // 2 and d_imp <= 1e-6,
              f"{name}: evaluate_batch vs the implicit engine {d_imp:.3e} on {int(both.sum())} lanes")
        if name == "invpend":
            explicit_tree_and_checkpoint(empc, th_dev)
    log(f"    [26] {time.perf_counter() - t_phase:.1f} s")


def explicit_tree_and_checkpoint(empc, th_dev):
    """[26] on invpend: the BST at leaf size 3 with the exact-descent check
    of ``tests/test_explicit.py::test_bst_exact_descent`` on 200 points,
    and a save_explicit / load_explicit round trip."""
    t0 = time.perf_counter()
    empc.build_tree(leaf_size=3)
    t_tree = time.perf_counter() - t0
    A, b, kids, leaf_off, leaf_reg, depth, _root = empc.bst_arrays()
    rng = np.random.default_rng(11)
    n_checked = 0
    for _ in range(200):
        theta = np.concatenate([rng.uniform(-15, 15, 4), rng.uniform(-15, 15, 2),
                                rng.uniform(-2, 2, 1)])
        u_scan = empc.evaluate(theta)
        if u_scan is None:
            continue
        node = 0
        for _d in range(depth + 1):
            node = kids[node, 1] if A[node] @ theta - b[node] > 0 else kids[node, 0]
            if node < 0:
                break
        check(node < 0, "BST: a descent did not end in a leaf")
        cands = leaf_reg[leaf_off[-node - 1]:leaf_off[-node]]
        hit = [r for r in cands if np.max(empc.regions[r].Ath @ theta - empc.regions[r].bth,
                                          initial=-np.inf) <= 1e-8]
        check(bool(hit), "BST: a leaf misses the region holding theta")
        cr = empc.regions[hit[0]]
        check(np.allclose(cr.F[: empc.nu] @ theta + cr.g[: empc.nu], u_scan, atol=1e-9),
              "BST: the leaf's law differs from the scan")
        n_checked += 1
    check(n_checked > 120, f"BST: {n_checked} points checked")
    log(f"    BST leaf size 3: {t_tree:.2f} s to build on the card's oracle, depth {depth}, "
        f"{len(leaf_off) - 1} leaves; exact descent on {n_checked} of 200 points")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/empc.npz"
        L.save_explicit(empc, path)
        back = L.load_explicit(path)
        u_back, _viol = back.evaluate_batch(th_dev[:N_ORACLE])
    u_src, _viol = empc.evaluate_batch(th_dev[:N_ORACLE])
    check(back.device.type == "cuda" and torch.equal(u_back, u_src),
          "save_explicit / load_explicit: u differs")
    log(f"    save_explicit / load_explicit: {len(back.regions)} regions, u on {N_ORACLE} "
        f"lanes equal after the round trip (on {back.device})")


def certification_phase(dev):
    """Phase [27]: iteration certification of invpend over its full
    default range with the LP oracle on the card. The IPM calls are timed
    on the host as they run and their inputs kept; afterwards every
    ``CERT_SAMPLE``-th call is replayed under torch.profiler for its device
    kernel time, scaled to all calls (the profiler's processing of all
    of them would take longer than the certification; a call's device time
    is its ~3000 small kernels, near 2 us each whatever the chunk's
    shape)."""
    from linearmpc_tpu_torch.ops import lp_ipm

    t_phase = time.perf_counter()
    mpc, prange = L.mpc_examples("invpend")
    mpc.setup()
    ipm, calls, ipm_s = lp_ipm.lp_ipm_batch, [], [0.0]

    def timed(A, b, c, x0, *, n_iter):
        t0 = time.perf_counter()
        out = ipm(A, b, c, x0, n_iter=n_iter)
        torch.cuda.synchronize()
        ipm_s[0] += time.perf_counter() - t0
        calls.append((A, b, c, x0, n_iter))
        return out

    lp_ipm.lp_ipm_batch = timed
    try:
        t0 = time.perf_counter()
        res = L.certify(mpc, prange=prange)
        wall = time.perf_counter() - t0
    finally:
        lp_ipm.lp_ipm_batch = ipm
    sample = calls[::CERT_SAMPLE]
    busy = device_busy_ms(lambda: [ipm(A, b, c, x0, n_iter=k) for A, b, c, x0, k in sample])
    busy *= len(calls) / len(sample)
    st = res.stats
    log(f"[27] certification, invpend, full default range, oracle on {dev}: {len(res.partition)} "
        f"regions, worst case {res.max_iterations} iterations, exhausted {res.exhausted}; "
        f"{wall:.1f} s; {st['ipm_chunks']} IPM chunks, {st['ipm_lanes']} lanes, "
        f"{st['highs']} lanes confirmed by HiGHS; IPM calls {ipm_s[0]:.2f} s on the host clock "
        f"({100 * ipm_s[0] / wall:.1f}% of the wall), their device kernels {busy / 1e3:.3f} s "
        f"({100 * busy / 1e3 / wall:.2f}% of the wall; every {CERT_SAMPLE}th call replayed, "
        f"scaled) on {card_line()}")
    check(not res.exhausted, "certification exhausted")
    check(len(res.partition) == 8909, f"certification: {len(res.partition)} regions, 8909 expected")
    check(res.max_iterations == 14, f"certification: worst case {res.max_iterations}, 14 expected")
    check(len(calls) == st["ipm_chunks"], "certification: IPM calls not counted")
    log(f"    [27] {time.perf_counter() - t_phase:.1f} s")


def c_control(lib, theta, nx, nr):
    """(flag, u[0]) of a generated controller at one theta (x, r, u_prev):
    u_prev through mpc_set_uprev, then mpc_compute_control."""
    ct = ctypes.c_double
    x, r, up = theta[:nx], theta[nx:nx + nr], theta[nx + nr:]
    lib.mpc_set_uprev((ct * len(up))(*up))
    u = (ct * 8)()
    flag = lib.mpc_compute_control(u, (ct * nx)(*x), (ct * nr)(*r), None)
    return flag, u[0]


def gcc_lib(cpath: str) -> ctypes.CDLL:
    so = cpath[:-2] + ".so"
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-o", so, cpath, "-lm"], check=True,
                   timeout=120)
    return ctypes.CDLL(so)


def codegen_phase(dev):
    """Phase [28]: the generated C of invpend (gcc) against the engine on the
    card, the explicit C against ``evaluate_batch`` on the card, and the
    native C++ runtime against the card engine."""
    t_phase = time.perf_counter()
    mpc, prange = L.mpc_examples("invpend")
    mpc.setup()
    eng = mpc.engine
    nx, nr, _nd, _nup, _np = mpc.get_parameter_dims()
    th = explicit_thetas(mpc, prange, np.random.default_rng(28), 256)
    with tempfile.TemporaryDirectory() as tmp:
        lib = gcc_lib(L.codegen_c(mpc, f"{tmp}/c"))
        flag_g, u_g = c_control(lib, mpc.form_parameter([5.0, 5.0, 0.0, 0.0], uprev=[0.0]),
                                nx, nr)
        res = [c_control(lib, t, nx, nr) for t in th]
        flags = np.array([f for f, _u in res])
        u_c = np.array([u for _f, u in res])
        sol = eng.solve_batch(torch.as_tensor(th, device=dev))
        u_card = (sol.U[:, 0] - torch.as_tensor(th[:, :nx] @ mpc.K[0], device=dev)).cpu().numpy()
        d_c = float(np.abs(u_c - u_card).max())
        log(f"[28] codegen: the generated C (gcc) golden u = {u_g:.10f} flag {flag_g}; 256 "
            f"states: flags all 1 {bool((flags == 1).all())}, max |u_C - u_card| {d_c:.3e} "
            f"(engine {eng.device} {str(eng.dtype)[6:]})")
        check(flag_g == 1 and abs(u_g - GOLDEN_U) <= 1e-6, f"generated C golden u {u_g}")
        check(bool((flags == 1).all()), f"generated C flags {sorted(set(flags.tolist()))}")
        check(d_c <= 1e-8, f"generated C vs the card engine: {d_c:.3e} > 1e-8")
        empc = L.build_explicit(mpc, prange=prange)
        lib_e = gcc_lib(L.codegen_c_explicit(empc, f"{tmp}/e"))
        u_e = np.array([c_control(lib_e, t, nx, nr)[1] for t in th])
        u_eval, _viol = empc.evaluate_batch(th)
        d_e = float(np.abs(u_e - u_eval[:, 0].cpu().numpy()).max())
        log(f"  explicit C ({len(empc.regions)} regions, BST depth {empc.bst_arrays()[5]}) vs "
            f"evaluate_batch on {u_eval.device}: max |du| {d_e:.3e}")
        check(u_eval.is_cuda and d_e <= 1e-9, f"explicit C vs evaluate_batch: {d_e:.3e}")
    th512 = sample_thetas(("invpend", None, None), np.random.default_rng(281), 512)
    native = NativeBatchSolver(eng.ldp, nu=mpc.model.nu)
    U_n, _it, st_n = native.solve_batch(th512)
    t_n = host_ms(lambda: native.solve_batch(th512), 5)
    sol_n = eng.solve_batch(torch.as_tensor(th512, device=dev))
    d_n = float(np.abs(U_n - sol_n.U.cpu().numpy()).max())
    log(f"  native C++ runtime B=512: status 1 {np.mean(st_n == 1):.6f}, max |U - U_card| "
        f"{d_n:.3e}; {min(t_n):.3f} ms a batch (best of 5, host CPU) = "
        f"{512 / min(t_n) * 1e3:,.0f} solves/s; the card engine on {card_line()}")
    check(bool((st_n == 1).all()) and d_n <= 1e-9, f"native runtime vs the card: {d_n:.3e}")
    log(f"    [28] {time.perf_counter() - t_phase:.1f} s")


def export_phase(dev, by_path: dict):
    """Phase [29]: ``export_compiled`` at B = 1024 for invpend (K1) and the
    m = 48 problem (K3 through ``bulk_inverse_updates``), ``load_compiled``,
    and the replay on the card against a direct ``solve_single`` call, bit
    for bit; the launches of the replays alone go to ``by_path["export"]``."""
    t_phase = time.perf_counter()
    B = 1024
    cases = []
    for label, mpc, th in (
            ("invpend", L.mpc_examples("invpend")[0].setup(),
             sample_thetas(("invpend", None, None), np.random.default_rng(29), B)),
            ("m=48", largem_mpc(12, None, None), largem_thetas(np.random.default_rng(291), B,
                                                                12.0))):
        eng = mpc.engine
        th_dev = torch.as_tensor(th, device=dev)
        direct = solve_single(eng.arrays, th_dev, **eng._single_kw)
        cases.append((label, mpc, th_dev, direct))
    with tempfile.TemporaryDirectory() as tmp:
        programs = []
        for label, mpc, th_dev, direct in cases:
            meta = L.export_compiled(mpc, f"{tmp}/{label}.pt2", batch=B)
            programs.append(L.load_compiled(f"{tmp}/{label}.pt2"))
            log(f"[29] export {label}: {meta}")
        torch.cuda.synchronize()
        reset_counts()
        outs = [fn(th_dev) for fn, (_l, _m, th_dev, _d) in zip(programs, cases)]
        torch.cuda.synchronize()
        by_path["export"] = read_counts()
        for fn, out, (label, mpc, th_dev, direct) in zip(programs, outs, cases):
            same = all(torch.equal(a, b) for a, b in zip(out, (direct.U, direct.iters,
                                                               direct.status)))
            t_rep = host_ms(lambda: fn(th_dev), 5)
            t_dir = host_ms(lambda: solve_single(mpc.engine.arrays, th_dev,
                                                 **mpc.engine._single_kw), 5)
            log(f"  replay {label} B={B} on {out[0].device}: equal to solve_single bit for bit "
                f"{same}, status 1 {(out[2] == 1).double().mean().item():.6f}; replay "
                f"{np.median(t_rep):.3f} ms vs direct {np.median(t_dir):.3f} ms (median of 5) "
                f"on {card_line()}")
            check(out[0].is_cuda and same, f"export {label}: the replay differs from solve_single")
    log(f"    export path launches (the replays alone): {by_path['export']}")
    check(by_path["export"]["bulk"] > 0 and by_path["export"]["iu"] > 0,
          "export: the replay launched no K1 or no K3")
    log(f"    [29] {time.perf_counter() - t_phase:.1f} s")


def profiling_phase(dev, by_path: dict):
    """Phase [30]: ``instrument`` on the cold B = 32768 tier, ``overlap_report``
    (its launches to ``by_path["overlap"]``), and a trace."""
    t_phase = time.perf_counter()
    mpc = L.mpc_examples("invpend")[0].setup()
    eng = mpc.engine
    th_dev = torch.as_tensor(sample_thetas(("invpend", None, None),
                                           np.random.default_rng(30), B_COLD), device=dev)
    stats = L.instrument(eng)
    for _ in range(4):
        eng.solve_batch(th_dev)
    s = stats.summary()
    log(f"[30] profiling: instrument, cold tier B={B_COLD} x 4: {s['solves_per_s']:,.1f} "
        f"solves/s, converged {s['converged_frac']:.6f}, mean iters {s['mean_iters']}, p99 "
        f"batch {1e3 * s['p99_batch_latency_s']:.3f} ms on {card_line()}")
    check(s["converged_frac"] == 1.0, f"instrument: converged {s['converged_frac']}")
    reset_counts()
    rep = profiling.overlap_report(L.mpc_examples("invpend")[0].setup(), B=B_COLD)
    torch.cuda.synchronize()
    by_path["overlap"] = read_counts()
    log(f"  overlap_report B={B_COLD}: K1 alone {1e3 * rep['t_phase1_s']:.4f} ms, K2 alone "
        f"{1e3 * rep['t_polish_s']:.4f} ms, the pair on two streams "
        f"{1e3 * rep['t_pair_s']:.4f} ms (sum {1e3 * rep['t_sum_s']:.4f}), fill_frac "
        f"{rep['fill_frac']:.4f}; launches {by_path['overlap']} on {card_line()}")
    check(by_path["overlap"]["bulk"] > 0 and by_path["overlap"]["polish"] > 0,
          "overlap_report launched no K1 or no K2")
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(f"{tmp}/tr"):
            eng.solve_batch(th_dev)
            torch.cuda.synchronize()
        size = Path(f"{tmp}/tr/trace.json").stat().st_size
    names = [s.name for s in profiling.spans()]
    log(f"  trace: {size} bytes of Chrome trace, program spans {names}")
    check(size > 0, "trace: empty file")
    check(names == ["lmpc.engine.solve_batch", "lmpc.small.k1", "lmpc.small.polish",
                     "lmpc.small.stragglers"], f"trace: program spans {names}")
    log(f"    [30] {time.perf_counter() - t_phase:.1f} s")


def schur_phase(dev):
    """Phase [31]: the mp-Schur row-sharded solver on a 1 x 1 mesh (NCCL, a
    world of one) at the JAX bench's shape (``bench.py:545-552``): invpend
    Np = 255, Nc = 8 with the +-18 box on ks 2..255 (m = 1024), float64,
    B = 256; the first 8 lanes the NumPy oracle converges on held to 1e-8;
    the threshold and the hybrid refusal of ``attach_mesh``."""
    from linearmpc_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    mpc, _ = L.mpc_examples("invpend", 255, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4), ks=range(2, 256))
    mpc.setup(dtype=torch.float64)
    eng = mpc.engine
    mesh = make_mesh(1, 1)
    eng.attach_mesh(mesh, force=True)
    rng = np.random.default_rng(31)
    B = 256
    th = np.hstack([rng.uniform(-5, 5, (B, 4)), rng.uniform(-5, 5, (B, 2)),
                    rng.uniform(-2, 2, (B, 1))])
    th_dev = torch.as_tensor(th, device=dev)
    sol = eng.solve_batch(th_dev)
    t_s = host_ms(lambda: eng.solve_batch(th_dev), 2)
    conv = (sol.status == 1).double().mean().item()
    U = sol.U.cpu().numpy()
    checked, err, scanned = 0, 0.0, 0
    for i in range(B):
        if checked == 8:
            break
        scanned += 1
        U_r, *_rest, s_r = solve_ldp_numpy(eng.ldp, th[i])
        if s_r == 1:
            check(int(sol.status[i]) == 1, f"mp-Schur lane {i}: status {int(sol.status[i])}")
            err = max(err, float(np.abs(U[i] - U_r).max()))
            checked += 1
    log(f"[31] mp-Schur on {mesh.device_type} (mesh {tuple(mesh.shape)}, backend "
        f"{torch.distributed.get_backend()}), m={eng.ldp.m}, float64, B={B}: "
        f"{B / min(t_s) * 1e3:,.1f} solves/s (best of 2: {min(t_s):.1f} ms), converged "
        f"{conv:.6f}, mean walk iterations {sol.iters.double().mean().item():.2f}; the first "
        f"{checked} oracle-converged lanes (of {scanned} scanned) max |U - U_oracle| {err:.3e} "
        f"on {card_line()}")
    check(sol.U.is_cuda and checked == 8 and err <= 1e-8, f"mp-Schur vs oracle: {err:.3e}")
    small = largem_mpc(12, None, torch.float64).engine
    small.attach_mesh(mesh)
    check(small._mp_solver is None, "attach_mesh routed an m=48 problem below the threshold")
    hybrid = L.mpc_examples("satellite")[0].setup().engine
    try:
        hybrid.attach_mesh(mesh)
        fail("attach_mesh took a hybrid engine")
    except ValueError as e:
        log(f"  below the threshold (m={small.ldp.m}) no mp solver; hybrid refused: {e}")
    torch.distributed.destroy_process_group()
    log(f"    [31] {time.perf_counter() - t_phase:.1f} s")


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

    # [1] build, one nvcc per source in parallel
    t0 = time.perf_counter()
    cuda_lib.build_all(KERNELS)
    log(f"[1] built kernels in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in cuda_lib.BUILD_SECONDS.items())})")
    for name, text in cuda_lib.PTXAS_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas {name}: {line.strip()}")

    # [2] K1 and [3] K2 against their plain versions on the card
    log("[2] K1 (bulk phase) vs phase1_plain, cold, B=32768, bit for bit")
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
    log("[3] K2 (polish) vs polish_plain, on the K1 working sets, bit for bit")
    for name, (act, side) in k2_inputs.items():
        mpc, th = engines[name]
        e = compare_k2(name, mpc.engine, th, act, side)
        if k2_err is None:
            k2_err = e

    # the small-m path: golden, cold batch, rollout -- launches counted here
    by_path = {}
    reset_counts()

    # [4] golden single solve through setup(device="cuda"), and through
    # setup() with no device, which runs on the card in float32
    mpc, _ = L.mpc_examples("invpend")
    mpc.setup(device="cuda", dtype=torch.float32)
    u = mpc.compute_control([5.0, 5.0, 0.0, 0.0])
    mpc_default, _ = L.mpc_examples("invpend")
    u_default = mpc_default.setup().compute_control([5.0, 5.0, 0.0, 0.0])
    eng_default = mpc_default.engine
    log(f"[4] golden u = {u[0]:.10f} (expected {GOLDEN_U}); setup() with no device: "
        f"{eng_default.device} {str(eng_default.dtype)[6:]}, u = {u_default[0]:.10f}")
    check(abs(u[0] - GOLDEN_U) <= 1e-6, f"golden u {u[0]} off by more than 1e-6")
    check(eng_default.device.type == "cuda" and eng_default.dtype == torch.float32,
          f"setup() with no device ran on {eng_default.device} {eng_default.dtype}")
    check(abs(u_default[0] - GOLDEN_U) <= 1e-6, f"default-device golden u {u_default[0]}")

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
    by_path["small"] = read_counts()
    launches = {"bulk": by_path["small"]["bulk"], "polish": by_path["small"]["polish"],
                "roll_merge": by_path["small"]["roll_finish_merge"]}
    launches["roll_gather"] = by_path["small"]["roll_finish"] - launches["roll_merge"]
    log(f"    small-m path launches: K1 {launches['bulk']}, K2 {launches['polish']}, the "
        f"finish's gather {launches['roll_gather']} and merge {launches['roll_merge']}")
    check(launches["bulk"] > 0 and launches["polish"] > 0, "a kernel was never launched")
    check(launches["roll_gather"] == launches["roll_merge"] == N_ROLL,
          f"the finish ran {launches['roll_gather']} gathers and {launches['roll_merge']} "
          f"merges in {N_ROLL} rollout steps")

    # [7] timings (CUDA events, after warm-up), at the main path's shapes
    args = phase1_inputs(eng, th, torch.float32)
    kw = dict(max_iter=eng.bulk_cap, primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)
    ms_k1 = cuda_ms(lambda: bulk.phase1(*args, **kw), 20)
    ms_k1p = cuda_ms(lambda: bulk.phase1_plain(*args, **kw), 3, warmup=1)
    out_k1 = bulk.phase1(*args, **kw)
    act, side = out_k1[1], out_k1[2]
    ms_k2 = cuda_ms(lambda: polish.polish(eng._pd, th_dev, act, side), 20)
    ms_k2p = cuda_ms(lambda: polish.polish_plain(eng._pd, th_dev, act, side), 20)
    dev_k1 = kernel_device_ms(lambda: [bulk.phase1(*args, **kw) for _ in range(5)],
                              "phase1_kernel")
    dev_k2 = kernel_device_ms(lambda: [polish.polish(eng._pd, th_dev, act, side)
                                       for _ in range(5)], "polish_kernel")
    b_k1 = k1_bound(args, out_k1)
    b_k2 = k2_bound(eng._pd, (eng._pd, th_dev, act, side),
                    polish.polish(eng._pd, th_dev, act, side))
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
    log(f"    K1 {ms_k1:.4f} ms (device {fmt_ms(dev_k1)}) vs phase1_plain {ms_k1p:.4f} ms; "
        f"bound {b_k1[0]:.5f} ms ({b_k1[1]})")
    log(f"    K2 {ms_k2:.4f} ms (device {fmt_ms(dev_k2)}) vs polish_plain {ms_k2p:.4f} ms; "
        f"bound {b_k2[0]:.5f} ms ({b_k2[1]})")
    log(f"    tier {ms_tier:.4f} ms/batch = {B_COLD / ms_tier * 1e3:,.0f} solves/s")
    log(f"    rollout {B_ROLL} x {N_ROLL} in {t_roll:.3f} s = "
        f"{B_ROLL * N_ROLL / t_roll:,.0f} control-steps/s")
    for text in (prof_k1, prof_k2, prof_tier, prof_roll):
        log(text)

    # [8] K3 against its plain version at the IU tier's shape
    log(f"[8] K3 (GI inverse update) vs phase1_iu_plain, cold, m=48, B={B_LARGE}")
    mpc_iu = largem_mpc(12, dev, torch.float32)
    eng_iu = mpc_iu.engine
    m_iu = eng_iu.ldp.m
    check(eng_iu.path == "iu" and m_iu == 48, f"IU case: path {eng_iu.path}, m={m_iu}")
    th_iu = largem_thetas(rng, B_LARGE, 12.0)
    k3_err = None
    for dtype in (torch.float32, torch.float64):
        args, kw = gi_inputs(eng_iu, th_iu, dtype)
        hi = eng_iu.arrays if dtype == torch.float32 else eng_iu.arrays_hi
        R0 = (eng_iu.iu_R0_init(B_LARGE) if dtype == torch.float32
              else iu.init_R_batch(hi.G_solve, args[7]))
        out_k = iu.phase1_iu(*args, R0, **kw)
        out_p = iu.phase1_iu_plain(*args, R0, **kw)
        torch.cuda.synchronize()
        err = compare_gi("K3", out_k, out_p, K3_FIELDS, 0, 6, dtype)
        k3_err = err if k3_err is None else max(k3_err, err)
        if dtype == torch.float32:
            out_cold = out_k
    # warm entry with the carried R and the warm-ray retry, as the rollout
    # step launches K3
    wargs, wkw = warm_gi_inputs(eng_iu, out_cold, th_iu, np.random.default_rng(1))
    R_w = out_cold[6]
    n_reset = int(iu.phase1_iu(*wargs, R_w, **dict(wkw, retry_infeas=False))[5].sum())
    out_k = iu.phase1_iu(*wargs, R_w, **wkw)
    out_p = iu.phase1_iu_plain(*wargs, R_w, **wkw)
    torch.cuda.synchronize()
    log(f"  K3 warm entry, retry_infeas=True: {n_reset} lanes flagged from their warm "
        f"start and restarted cold")
    k3_err = max(k3_err, compare_gi("K3 warm+retry", out_k, out_p, K3_FIELDS, 0, 6,
                                    torch.float32))

    # the IU path: cold tier and warm rollout -- K3's launches counted here
    reset_counts()
    th_iu_dev = torch.as_tensor(th_iu, device=dev)
    sol = eng_iu.solve_batch(th_iu_dev)
    check(torch.isfinite(sol.U).all().item(), "IU tier: non-finite controls")
    e, wrong, decided = oracle_error(eng_iu.ldp, th_iu[:128], sol.U[:128].cpu().numpy(),
                                     sol.status[:128].cpu().numpy())
    log(f"[9] IU tier B={B_LARGE}: {status_line(sol)}, mean iters "
        f"{sol.iters.double().mean().item():.2f}; over 128 lanes max |U - U_oracle| {e:.3e}, "
        f"{wrong} of {decided} oracle verdicts contradicted; K3 launches +{iu.LAUNCHES}")
    check(bool((sol.status != -1).all()), "IU tier: a lane with status -1")
    check(e <= 1e-9, f"IU tier error {e:.3e} > 1e-9")
    check(wrong == 0, f"IU tier: {wrong} statuses contradict the oracle")
    roll_iu, x0_iu, rs_iu, _ = rollout_check("[10] IU rollout", mpc_iu, 12, rng,
                                             B_ROLL_IU, N_ROLL_IU, 8)
    by_path["iu"] = read_counts()
    launches["iu"] = by_path["iu"]["iu"]
    launches["iu_epilogue"] = by_path["iu"]["iu_epilogue"]
    log(f"    IU path launches: K3 {launches['iu']}, epilogue {launches['iu_epilogue']}")
    check(launches["iu"] > 0, "K3 was never launched on the IU path")
    check(launches["iu_epilogue"] == N_ROLL_IU,
          f"the epilogue ran {launches['iu_epilogue']} times in {N_ROLL_IU} rollout steps")
    ep_args = epilogue_inputs(eng_iu, roll_iu, x0_iu, rs_iu)
    ep_err = compare_epilogue("epilogue of warm rollout step 10 vs _rollout_epilogue_plain",
                              eng_iu, ep_args)

    # [11] K4 against its plain version at the compact tier's shape
    mpc_c = largem_mpc(32, dev, torch.float32)
    eng_c = mpc_c.engine
    m_c, s_c = eng_c.ldp.m, eng_c.ciu_s_max
    s_g = ciu.up8(2 * s_c)
    log(f"[11] K4 (compact GI) vs phase1_ciu_plain, cold, m={m_c}, B={B_LARGE}, "
        f"s={s_c} (f32 bulk, cap {eng_c.bulk_cap_p}) and s={s_g} (f64 guard)")
    check(eng_c.path == "compact" and m_c == 128, f"compact case: path {eng_c.path}, m={m_c}")
    th_c = largem_thetas(rng, B_LARGE, 10.0)
    k4_err = None
    for dtype in (torch.float32, torch.float64):
        args, kw = gi_inputs(eng_c, th_c, dtype)
        if dtype == torch.float32:
            sl0, Rw0 = eng_c._ciu_cold_carry(B_LARGE)
            kw["max_iter"] = eng_c.bulk_cap_p
        else:
            Rw0, sl0, _ = ciu.init_compact_batch(eng_c.arrays_hi.G_solve, args[7], s_g)
        out_k = ciu.phase1_ciu(*args, sl0, Rw0, **kw)
        out_p = ciu.phase1_ciu_plain(*args, sl0, Rw0, **kw)
        torch.cuda.synchronize()
        err = compare_gi("K4", out_k, out_p, K4_FIELDS, 0, 8, dtype)
        k4_err = err if k4_err is None else max(k4_err, err)
        if dtype == torch.float32:
            out_cold = out_k
    # warm entry with the carried slots and Rw and the warm-ray retry, as
    # the rollout step and the second chance launch K4
    wargs, wkw = warm_gi_inputs(eng_c, out_cold, th_c, np.random.default_rng(2))
    sl_w, Rw_w = out_cold[7], out_cold[8]
    n_reset = int(ciu.phase1_ciu(*wargs, sl_w, Rw_w, **dict(wkw, retry_infeas=False))[5].sum())
    out_k = ciu.phase1_ciu(*wargs, sl_w, Rw_w, **wkw)
    out_p = ciu.phase1_ciu_plain(*wargs, sl_w, Rw_w, **wkw)
    torch.cuda.synchronize()
    log(f"  K4 warm entry, retry_infeas=True: {n_reset} lanes flagged from their warm "
        f"start and restarted cold")
    k4_err = max(k4_err, compare_gi("K4 warm+retry", out_k, out_p, K4_FIELDS, 0, 8,
                                    torch.float32))

    # the compact path: cold tier and warm rollout -- K4's launches counted here
    reset_counts()
    th_c_dev = torch.as_tensor(th_c, device=dev)
    sol = eng_c.solve_batch(th_c_dev)
    check(torch.isfinite(sol.U).all().item(), "compact tier: non-finite controls")
    e, wrong, decided = oracle_error(eng_c.ldp, th_c[:96], sol.U[:96].cpu().numpy(),
                                     sol.status[:96].cpu().numpy())
    log(f"[12] compact tier B={B_LARGE}, s={s_c}/{eng_c._ciu_s2}: {status_line(sol)}, mean "
        f"iters {sol.iters.double().mean().item():.2f}; over 96 lanes max |U - U_oracle| "
        f"{e:.3e}, {wrong} of {decided} oracle verdicts contradicted; second chance "
        f"{eng_c.stats['second_chance']} lanes ({eng_c.stats['second_taken']} taken), f64 "
        f"guard {eng_c.stats['guard']} lanes, ladder {eng_c.stats['ladder']} lanes; K4 "
        f"launches +{ciu.LAUNCHES}")
    check(bool((sol.status != -1).all()), "compact tier: a lane with status -1")
    check(e <= 1e-9, f"compact tier error {e:.3e} > 1e-9")
    check(wrong == 0, f"compact tier: {wrong} statuses contradict the oracle")
    # a lane of another draw whose float64 guard and first ladder pass fail
    # (the last through an overflowed inverse): it must end -3 with finite
    # controls, as the JAX package's guard returns it
    th_l = torch.as_tensor(np.load(LANE_CASE)["theta"][None], device=dev)
    sol_l = eng_c.solve_batch(th_l)
    fin_l = bool(torch.isfinite(sol_l.U).all())
    log(f"  the lane of tests/data/{LANE_CASE.name} alone: status {int(sol_l.status[0])}, "
        f"controls finite {fin_l}, guard {eng_c.stats['guard']} ladder "
        f"{eng_c.stats['ladder']} lanes, {int(sol_l.iters[0])} iterations")
    check(int(sol_l.status[0]) == -3 and fin_l,
          f"the {LANE_CASE.name} lane: status {int(sol_l.status[0])}, finite controls {fin_l}")
    roll_c, x0_c, rs_c, _ = rollout_check("[13] compact rollout", mpc_c, 32, rng,
                                          B_ROLL_C, N_ROLL_C, 0)
    by_path["compact"] = read_counts()
    launches["ciu"] = by_path["compact"]["ciu"]
    log(f"    compact path launches: K4 {launches['ciu']}")
    check(launches["ciu"] > 0, "K4 was never launched on the compact path")

    # [14] large-m timings (CUDA events after warm-up; rollouts on the host
    # clock ending in a synchronize), at the paths' shapes
    args3, kw3 = gi_inputs(eng_iu, th_iu, torch.float32)
    R03 = eng_iu.iu_R0_init(B_LARGE)
    ms_k3 = cuda_ms(lambda: iu.phase1_iu(*args3, R03, **kw3), 10)
    ms_k3p = cuda_ms(lambda: iu.phase1_iu_plain(*args3, R03, **kw3), 1, warmup=1)
    args4, kw4 = gi_inputs(eng_c, th_c, torch.float32)
    kw4["max_iter"] = eng_c.bulk_cap_p
    sl04, Rw04 = eng_c._ciu_cold_carry(B_LARGE)
    ms_k4 = cuda_ms(lambda: ciu.phase1_ciu(*args4, sl04, Rw04, **kw4), 10)
    ms_k4p = cuda_ms(lambda: ciu.phase1_ciu_plain(*args4, sl04, Rw04, **kw4), 1, warmup=1)
    out_k3 = iu.phase1_iu(*args3, R03, **kw3)
    k3_bound = gi_bound(args3 + (R03,), out_k3)
    k4_bound = gi_bound(args4 + (sl04, Rw04), ciu.phase1_ciu(*args4, sl04, Rw04, **kw4))
    dev_k3 = kernel_device_ms(lambda: [iu.phase1_iu(*args3, R03, **kw3) for _ in range(5)],
                              "iu_kernel")
    dev_k4 = kernel_device_ms(lambda: [ciu.phase1_ciu(*args4, sl04, Rw04, **kw4)
                                       for _ in range(5)], "ciu_kernel")
    ms_ep = cuda_ms(lambda: run_epilogue(eng_iu, *ep_args), 10)
    ms_ep_p = cuda_ms(lambda: eng_iu._rollout_epilogue_plain(*ep_args), 3, warmup=1)
    dev_ep = kernel_device_ms(lambda: [run_epilogue(eng_iu, *ep_args) for _ in range(5)],
                              "epilogue_kernel")
    ep_bound = epilogue_bound(eng_iu, ep_args, run_epilogue(eng_iu, *ep_args))
    ms_iu = cuda_ms(lambda: eng_iu.solve_batch(th_iu_dev), 5)
    ms_c = cuda_ms(lambda: eng_c.solve_batch(th_c_dev), 5)
    t_rolls = {}
    for name, (roll, x0, rs, N) in (("iu", (roll_iu, x0_iu, rs_iu, N_ROLL_IU)),
                                    ("c", (roll_c, x0_c, rs_c, N_ROLL_C))):
        t0 = time.perf_counter()
        roll(x0, rs, None, N=N)
        torch.cuda.synchronize()
        t_rolls[name] = time.perf_counter() - t0
    profs = [
        device_profile("K3 per launch", lambda: [iu.phase1_iu(*args3, R03, **kw3)
                                                 for _ in range(5)], 5, ms_k3),
        device_profile(f"IU tier per batch of {B_LARGE}",
                       lambda: [eng_iu.solve_batch(th_iu_dev) for _ in range(3)], 3, ms_iu),
        device_profile(f"IU rollout per step of {B_ROLL_IU} lanes",
                       lambda: roll_iu(x0_iu, rs_iu, None, N=20), 20,
                       1e3 * t_rolls["iu"] / N_ROLL_IU),
        device_profile("K4 per launch", lambda: [ciu.phase1_ciu(*args4, sl04, Rw04, **kw4)
                                                 for _ in range(5)], 5, ms_k4),
        device_profile(f"compact tier per batch of {B_LARGE}",
                       lambda: [eng_c.solve_batch(th_c_dev) for _ in range(3)], 3, ms_c),
        device_profile(f"compact rollout per step of {B_ROLL_C} lanes",
                       lambda: roll_c(x0_c, rs_c, None, N=20), 20,
                       1e3 * t_rolls["c"] / N_ROLL_C),
    ]
    card = card_line()
    log(f"[14] timings on {card}, m=48 (IU) and m={m_c} (compact), B={B_LARGE}:")
    log(f"    K3 {ms_k3:.4f} ms (device {fmt_ms(dev_k3)}) vs phase1_iu_plain {ms_k3p:.4f} ms; "
        f"bound {k3_bound[0]:.5f} ms ({k3_bound[1]})")
    log(f"    K4 {ms_k4:.4f} ms (device {fmt_ms(dev_k4)}) vs phase1_ciu_plain {ms_k4p:.4f} ms; "
        f"bound {k4_bound[0]:.5f} ms ({k4_bound[1]})")
    log(f"    IU rollout epilogue (warm step, B={B_ROLL_IU}) {ms_ep:.4f} ms (device "
        f"{fmt_ms(dev_ep)}) vs _rollout_epilogue_plain {ms_ep_p:.4f} ms; bound "
        f"{ep_bound[0]:.5f} ms ({ep_bound[1]})")
    log(f"    IU tier {ms_iu:.4f} ms/batch = {B_LARGE / ms_iu * 1e3:,.0f} solves/s")
    log(f"    compact tier {ms_c:.4f} ms/batch = {B_LARGE / ms_c * 1e3:,.0f} solves/s")
    log(f"    IU rollout {B_ROLL_IU} x {N_ROLL_IU} in {t_rolls['iu']:.3f} s = "
        f"{B_ROLL_IU * N_ROLL_IU / t_rolls['iu']:,.0f} control-steps/s")
    log(f"    compact rollout {B_ROLL_C} x {N_ROLL_C} in {t_rolls['c']:.3f} s = "
        f"{B_ROLL_C * N_ROLL_C / t_rolls['c']:,.0f} control-steps/s")
    for text in profs:
        log(text)

    # [15] K3/K4 against their plain versions off the paths' shapes
    log("[15] K3/K4 vs plain: ragged batches from one shared entry inverse, a per-lane eq, "
        "the wide-team paths")
    eng_160 = largem_mpc(40, dev, torch.float32).engine
    check(eng_160.ldp.m == 160, f"m=160 case: m={eng_160.ldp.m}")
    compare_off_path(off_path_cases(eng_iu, eng_c, eng_160))

    # [16] the K3/K4 launches of the large-m paths, replayed alone
    log("[16] K3/K4 launches of the large-m paths: vs plain, call / device / plain time, bound")
    replay_launches(gi_launches(eng_iu, mpc_iu, th_iu, eng_c, mpc_c, th_c,
                                np.random.default_rng(3)))

    # [17] the K1/K2 launches of the small-m path, replayed alone, and its
    # host syncs
    log("[17] K1/K2 launches of the small-m path and the finish's gather and merge: vs plain, "
        "call / device / plain time, bound")
    rs_small = np.zeros((B_ROLL, 2))
    small_rows = replay_small(small_launches(mpc, th_dev, x0s, rs_small))
    finish_rows = roll_finish_phase(mpc)
    n_sync = sync_checks(mpc, th_dev, x0s, rs_small)
    log(f"    rollout step under set_sync_debug_mode('error'): no sync; one cold batch of "
        f"{B_COLD} under 'warn': {n_sync} synchronizing calls")

    step_rows, k3_step_err, lex_rows = hybrid_lex_phases(dev, by_path)
    contact_phases(dev, by_path)
    single_k1_rows, single_k3_rows = single_phases(dev, by_path)
    unmeasured_phases(dev)
    lp_oracle_phase(dev)
    explicit_phase(dev)
    certification_phase(dev)
    # the deployment and tooling paths, the mp-Schur solver
    codegen_phase(dev)
    export_phase(dev, by_path)
    profiling_phase(dev, by_path)
    schur_phase(dev)

    # the counts of each kernel on each path's run
    per_path = lambda k: {p: by_path[p][k] for p in PATHS}
    none = "none: no single PyTorch call computes an early-exit active-set iteration"
    log(f"    library call for K1-K4: {none}")
    kernels = [
        {"name": "K1 bulk phase", "route": "cuda",
         "source": "linearmpc_tpu_torch/csrc/bulk.cu",
         "replaces": "linearmpc_tpu/ops/pallas_solver.py:58",
         "launches": launches["bulk"], "launches_by_path": per_path("bulk"),
         "max_abs_err": k1_err, "ms": ms_k1, "device_ms": dev_k1, "plain_ms": ms_k1p,
         "bound_ms": b_k1[0], "bound_by": b_k1[1], "library_ms": None,
         "launch_shapes": {**small_rows["K1"], **lex_rows, **single_k1_rows}},
        {"name": "K2 polish", "route": "cuda",
         "source": "linearmpc_tpu_torch/csrc/polish.cu",
         "replaces": "linearmpc_tpu/ops/pallas_polish.py:144",
         "launches": launches["polish"], "launches_by_path": per_path("polish"),
         "max_abs_err": k2_err, "ms": ms_k2, "device_ms": dev_k2, "plain_ms": ms_k2p,
         "bound_ms": b_k2[0], "bound_by": b_k2[1], "library_ms": None,
         "launch_shapes": small_rows["K2"]},
        {"name": "K3 GI inverse update", "route": "cuda",
         "source": "linearmpc_tpu_torch/csrc/iu.cu",
         "replaces": "linearmpc_tpu/ops/pallas_iu.py:107",
         "launches": launches["iu"], "launches_by_path": per_path("iu"),
         "max_abs_err": max(k3_err, k3_step_err), "ms": ms_k3, "device_ms": dev_k3,
         "plain_ms": ms_k3p, "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": None, "launch_shapes": {**step_rows, **single_k3_rows}},
        {"name": "K4 compact GI", "route": "cuda",
         "source": "linearmpc_tpu_torch/csrc/ciu.cu",
         "replaces": "linearmpc_tpu/ops/pallas_ciu.py:113",
         "launches": launches["ciu"], "launches_by_path": per_path("ciu"),
         "max_abs_err": k4_err, "ms": ms_k4, "device_ms": dev_k4, "plain_ms": ms_k4p,
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None},
        {"name": "IU rollout epilogue", "route": "cuda",
         "source": "linearmpc_tpu_torch/csrc/iu_epilogue.cu",
         "replaces": "linearmpc_tpu/ops/engine.py:355-410 (left to XLA, no Pallas kernel)",
         "launches": launches["iu_epilogue"], "launches_by_path": per_path("iu_epilogue"),
         "max_abs_err": ep_err, "ms": ms_ep, "device_ms": dev_ep, "plain_ms": ms_ep_p,
         "bound_ms": ep_bound[0], "bound_by": ep_bound[1], "library_ms": None},
        *({"name": f"small-m rollout finish {kind}", "route": "cuda",
           "source": "linearmpc_tpu_torch/csrc/roll_finish.cu",
           "replaces": "none: the JAX rollout step has no finish "
                       "(linearmpc_tpu/ops/engine.py:1218-1241)",
           "launches": launches[f"roll_{kind}"], "launches_by_path": by_kind, **finish_rows[kind],
           "library_ms": None}
          for kind, by_kind in (
              ("gather", {p: by_path[p]["roll_finish"] - by_path[p]["roll_finish_merge"]
                          for p in PATHS}),
              ("merge", per_path("roll_finish_merge")))),
    ]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
