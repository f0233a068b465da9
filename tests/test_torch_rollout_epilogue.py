"""The warm IU rollout step's epilogue kernel (``ops/iu_epilogue.py``,
``csrc/iu_epilogue.cu``) against its plain version,
``SolverEngine._rollout_epilogue_plain``.

The tests marked ``gpu`` skip without CUDA. The file imports no JAX, so on a
card:

    python -m pytest --noconftest -m gpu tests/test_torch_rollout_epilogue.py

On the card: the kernel against the plain version on K3's outputs of a
warm crazyflie step (m = n = 40, n_theta = 12) at B = 1, 64 and 4096, and
of an invpend step at m = 41 (odd: the kernel's pads and narrow copies)
at B = 257, with lanes flagged infeasible and lanes not done (set by hand:
the crazyflie's input box is never infeasible), so that statuses -3 and -1
appear; then a 750-step, 4096-lane closed loop through the kernel against
the same loop through the plain version, with the solve's spans and the
kernel's lane counter. The two need not agree bit for bit (the kernel's
float32 sums need not take cuBLAS's order). Measured on an H100, as
max |a - b| / (1 + |b|), the benchmark's ``u_err`` form, over every finite
entry: statuses and non-finite entries equal; crazyflie U equal, lam
within 5.2e-27, R within 1.7e-7 at B = 1 and equal at 64 and 4096;
invpend U and R equal, lam within 2.2e-21; the closed loop's controls and
states equal. (At B = 4096 invpend's unresolved lanes, R up to 4e17, part
by up to 5.5e-3 in U; its status-1 lanes stay equal.) The kernel is also
held to the plain version, at the same bounds, on the inputs of the 11th
warm step of the IU path's own rollout (invpend 50/8 with the +-18 state
box, m = 48, 4096 lanes).

On the CPU: the wrapper refuses a wrong dtype, shape, size or device before
it builds or launches anything.
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import linearmpc_tpu_torch as L
from linearmpc_tpu_torch import profiling as P
from linearmpc_tpu_torch.ops import cuda_lib, iu_epilogue
from linearmpc_tpu_torch.ops.engine import full_f32


def _setup(mpc, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc.setup(device=device, dtype=torch.float32)
    assert mpc.engine.path == "iu"
    return mpc


def _crazyflie(device):
    return _setup(L.mpc_examples("crazyflie")[0], device)


def _invpend41(device):
    """invpend at Np = 50, Nc = 8 with three state bounds on steps 2-12:
    m = 41 (odd, below the kernel's padded order 48), n = 8, n_theta = 7."""
    mpc, _ = L.mpc_examples("invpend", 50, 8)
    mpc.add_constraint(Ax=np.eye(4)[:3], lb=-18 * np.ones(3), ub=18 * np.ones(3),
                       ks=range(2, 13))
    return _setup(mpc, device)


# each problem with its thetas: crazyflie's x in +-1; invpend's x and r in
# +-20 and u_prev in +-2
PROBLEMS = {
    "crazyflie": (_crazyflie, lambda rng, B: rng.uniform(-1, 1, (B, 12))),
    "invpend m=41": (_invpend41, lambda rng, B: np.hstack(
        [rng.uniform(-20, 20, (B, 6)), rng.uniform(-2, 2, (B, 1))])),
}


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs() / (1.0 + b.abs())).max().item()


def _agree(a, b, tol):
    """The same non-finite entries, and the finite ones within ``tol``
    (the benchmark's ``u_err`` form)."""
    a, b = a.double(), b.double()
    assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.isinf(), b.isinf())
    assert torch.equal(a[a.isinf()], b[b.isinf()])
    fin = torch.isfinite(b)
    assert _rel(a[fin], b[fin]) <= tol


def _warm_k3(eng, thetas, B, seed):
    """(theta, act, side, done, infeas, R): K3's outputs of the second step
    from ``thetas``, warm from the first step's state, as
    ``fused_rollout_solve_iu`` runs it; on B >= 64, every 7th lane from the
    5th flagged infeasible and every 11th from the 3rd not done."""
    dev, m = eng.device, eng.ldp.m
    rng = np.random.default_rng(seed)
    th = torch.as_tensor(thetas(rng, B), dtype=torch.float32, device=dev)
    cold = (torch.zeros((B, m), dtype=torch.float32, device=dev),
            torch.zeros((B, m), dtype=torch.bool, device=dev),
            torch.ones((B, m), dtype=torch.bool, device=dev), eng.iu_R0_init(B))
    _U, lam, act, side, _it, _st, R = eng.fused_rollout_solve_iu(th, *cold)
    th = th + torch.as_tensor(rng.normal(0, 0.05, th.shape), dtype=torch.float32, device=dev)
    with full_f32():
        du_t, dl_t = eng._bounds32(th)
        _lam, act, side, _it, done, infeas, R = eng._iu_phase1(
            du_t, dl_t, lam, act | eng.arrays.is_eq, side, R, retry=True)
    if B >= 64:
        infeas[5::7] = True
        done[3::11] = False
    return th, act, side, done, infeas, R


@pytest.mark.gpu
@pytest.mark.parametrize("problem,B", [("crazyflie", 1), ("crazyflie", 64), ("crazyflie", 4096),
                                       ("invpend m=41", 257)])
def test_epilogue_kernel_matches_plain(problem, B):
    make, thetas = PROBLEMS[problem]
    eng = make("cuda").engine
    args = _warm_k3(eng, thetas, B, seed=B)
    before = iu_epilogue.LAUNCHES
    with full_f32():
        Uk, lk, sk, Rk = eng._rollout_epilogue_cuda(*args)
        Up, lp, sp, Rp = eng._rollout_epilogue_plain(*args)
    torch.cuda.synchronize()
    assert iu_epilogue.LAUNCHES == before + 1
    assert torch.equal(sk, sp)
    if B >= 64:
        assert {-3, -1, 1} <= set(sk.tolist())
    _agree(Uk, Up, 1e-6)
    _agree(lk, lp, 1e-6)
    _agree(Rk, Rp, 1e-5)


@pytest.mark.gpu
def test_rollout_through_kernel_matches_plain(monkeypatch):
    """4096 lanes x 750 steps from x0 uniform in +-1: the closed loop
    through the kernel against the one through the plain epilogue; under a
    profiler session each solve span holds K3's and the kernel's, and the
    lane counter sums to N x B."""
    mpc = _crazyflie("cuda")
    eng = mpc.engine
    B, N = 4096, 750
    x0 = np.random.default_rng(7).uniform(-1, 1, (B, 12)).astype(np.float32)
    roll = L.build_rollout(mpc)
    with profile(activities=[ProfilerActivity.CPU]):
        fused = roll(x0, None, None, N=N)
    spans, counts = P.spans(), P.counts()
    monkeypatch.setattr(eng, "_rollout_epilogue_cuda", eng._rollout_epilogue_plain)
    plain = roll(x0, None, None, N=N)
    assert torch.equal(fused.status, plain.status)
    assert (plain.status == 1).double().mean().item() > 0.99
    assert _rel(fused.us, plain.us) <= 2e-5
    solves = [i for i, s in enumerate(spans) if s.name == "lmpc.rollout.solve"]
    assert len(solves) == N
    for i in solves:
        assert [s.name for s in spans if s.parent == i] == ["lmpc.iu.k3", "lmpc.iu.epilogue"]
    assert counts["iu.epilogue_lanes"] == N * B


def _box48(device):
    """invpend at Np = 50, Nc = 8 with the +-18 state box on steps 2-11:
    the IU path's m = 48."""
    mpc, _ = L.mpc_examples("invpend", 50, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4), ks=range(2, 12))
    return _setup(mpc, device)


@pytest.mark.gpu
def test_epilogue_kernel_matches_plain_on_the_iu_rollout_step(monkeypatch):
    """The kernel against the plain version on the inputs with which the
    11th warm step of the m = 48 box's 4096-lane rollout (x0 in +-0.25)
    enters it, every 7th lane from the 5th flagged infeasible and every
    11th from the 3rd not done: statuses equal, -3, -1 and 1 among them,
    and the values within the bounds of the other cases."""
    mpc = _box48("cuda")
    eng = mpc.engine
    calls, kernel = [], eng._rollout_epilogue_cuda
    monkeypatch.setattr(eng, "_rollout_epilogue_cuda", lambda *a: calls.append(a) or kernel(*a))
    x0 = np.random.default_rng(10).uniform(-0.25, 0.25, (4096, 4))
    L.build_rollout(mpc)(x0, np.zeros((4096, 2)), None, N=11)
    assert len(calls) == 11
    th, act, side, done, infeas, R = calls[10]
    done, infeas = done.clone(), infeas.clone()
    infeas[5::7] = True
    done[3::11] = False
    args = (th, act, side, done, infeas, R)
    with full_f32():
        Uk, lk, sk, Rk = kernel(*args)
        Up, lp, sp, Rp = eng._rollout_epilogue_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and {-3, -1, 1} <= set(sk.tolist())
    _agree(Uk, Up, 1e-6)
    _agree(lk, lp, 1e-6)
    _agree(Rk, Rp, 1e-5)


@functools.lru_cache(maxsize=1)
def _cpu_engine():
    return _crazyflie("cpu").engine


def _cpu_inputs(B=3):
    eng = _cpu_engine()
    arr, hi, m = eng.arrays, eng.arrays_hi, eng.ldp.m
    Gs = arr.G_solve + 4.0 * float(np.finfo(np.float32).eps) * torch.eye(m)
    statics = dict(Gs=Gs, G=hi.G_solve, Dth=hi.Dth, du=hi.du, dl=hi.dl, u_off=hi.u_off,
                   Uth_off=hi.Uth_off, HinvET=hi.HinvET)
    lanes = dict(thetas=torch.zeros((B, 12)), R=torch.eye(m).expand(B, m, m).contiguous(),
                 act=torch.zeros((B, m), dtype=torch.bool),
                 side=torch.ones((B, m), dtype=torch.bool),
                 done=torch.ones(B, dtype=torch.bool), infeas=torch.zeros(B, dtype=torch.bool))
    return {**statics, **lanes}


BAD = {
    "on the CPU": (lambda a: a, ValueError),
    "R float64": (lambda a: {**a, "R": a["R"].double()}, TypeError),
    "Gs float64": (lambda a: {**a, "Gs": a["Gs"].double()}, TypeError),
    "thetas int": (lambda a: {**a, "thetas": a["thetas"].int()}, TypeError),
    "thetas float64": (lambda a: {**a, "thetas": a["thetas"].double()}, TypeError),
    "act as float": (lambda a: {**a, "act": a["act"].float()}, TypeError),
    "act (B, m + 1)": (lambda a: {**a, "act": torch.zeros((3, 41), dtype=torch.bool)},
                       ValueError),
    "R (B, m, m - 1)": (lambda a: {**a, "R": a["R"][:, :, 1:]}, ValueError),
    "Dth (m, n_theta + 1)": (lambda a: {**a, "Dth": torch.zeros((40, 13), dtype=torch.float64)},
                             ValueError),
    "done (B + 1,)": (lambda a: {**a, "done": torch.ones(4, dtype=torch.bool)}, ValueError),
    "m = 57": (lambda a: {**a, "G": torch.eye(57, dtype=torch.float64)}, ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_epilogue_refuses_bad_inputs_before_launch(case, monkeypatch):
    edit, exc = BAD[case]
    built = []
    monkeypatch.setattr(cuda_lib, "load", lambda *a: built.append(a))
    monkeypatch.setattr(cuda_lib, "function", lambda *a: built.append(a))
    before = iu_epilogue.LAUNCHES
    with pytest.raises(exc):
        iu_epilogue.epilogue(**edit(_cpu_inputs()), refine=4, res_tol=1e-6)
    assert iu_epilogue.LAUNCHES == before
    assert built == []
