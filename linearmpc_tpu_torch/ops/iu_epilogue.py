"""The warm IU rollout step's epilogue in one launch (``csrc/iu_epilogue.cu``).

``SolverEngine.fused_rollout_solve_iu`` runs K3 (``ops/iu.py``) and then,
per lane, one float32 Newton-Schulz pass on the carried inverse R, the
float64 bounds, a short float64 Richardson refinement through the new R,
the controls U and the step's status. Written as plain torch that is about a
hundred small launches a control step; on the card this module runs it as
one kernel. It replaces no Pallas kernel: the JAX package leaves the same
stretch to XLA's fusion. Its plain version is
``SolverEngine._rollout_epilogue_plain``, which the engine runs on the CPU;
the two agree to rounding (their float32 products sum in other orders).

``epilogue`` checks every input before it builds or launches anything and
raises on a CPU tensor: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

# kernel launches (the count a run reads to show the rollout step went
# through the kernel)
LAUNCHES = 0
MAX_M = 56  # the kernel's tile holds at most 7 rows a thread

_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 18
             + [ctypes.c_int, ctypes.c_double, ctypes.c_void_p])


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"iu_epilogue: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"iu_epilogue: {name} must have shape {shape}, got {tuple(t.shape)}")


def epilogue(Gs, G, Dth, du, dl, u_off, Uth_off, HinvET, thetas, R, act, side, done, infeas, *,
             refine: int, res_tol: float):
    """(U, lam, status, R_new) of the warm IU step's epilogue, one launch.

    Statics: ``Gs`` = G_solve + 4 eps32 I (m, m) float32; ``G`` the float64
    G_solve (m, m), ``Dth`` (m, n_theta), ``du``/``dl`` (m,), ``u_off``
    (n,), ``Uth_off`` (n, n_theta), ``HinvET`` (n, m), float64. Per lane,
    K3's outputs ``R`` (B, m, m) float32, ``act``/``side`` (B, m) and
    ``done``/``infeas`` (B,) bool, and ``thetas`` (B, n_theta) float32.
    Returns U (B, n) and lam (B, m) float32, status (B,) int32 and the new
    R (B, m, m) float32; ``refine`` Richardson passes, status 1 where the
    relative working-set residual is within ``res_tol``. The launch fails
    where the statics leave no room in shared memory for a lane."""
    global LAUNCHES
    m, n = G.shape[0], u_off.shape[0]
    B, nth = thetas.shape[0], Dth.shape[1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"iu_epilogue takes 1 <= m <= {MAX_M}, got m = {m}")
    f64 = torch.float64
    for name, t, dtype, shape in (
            ("Gs", Gs, torch.float32, (m, m)), ("G", G, f64, (m, m)), ("Dth", Dth, f64, (m, nth)),
            ("du", du, f64, (m,)), ("dl", dl, f64, (m,)), ("u_off", u_off, f64, (n,)),
            ("Uth_off", Uth_off, f64, (n, nth)), ("HinvET", HinvET, f64, (n, m)),
            ("thetas", thetas, torch.float32, (B, nth)), ("R", R, torch.float32, (B, m, m)),
            ("act", act, torch.bool, (B, m)), ("side", side, torch.bool, (B, m)),
            ("done", done, torch.bool, (B,)), ("infeas", infeas, torch.bool, (B,))):
        _check(name, t, dtype, shape)
    ins = [t.contiguous() for t in (Gs, G, Dth, du, dl, u_off, Uth_off, HinvET, thetas)]
    lane_ins = [t.contiguous() for t in (R, act, side, done, infeas)]
    dev = R.device
    if dev.type != "cuda" or any(t.device != dev for t in ins + lane_ins):
        raise ValueError("iu_epilogue runs on CUDA tensors of one device, got "
                         f"{sorted({str(t.device) for t in ins + lane_ins})}")
    U = torch.empty((B, n), dtype=torch.float32, device=dev)
    lam = torch.empty((B, m), dtype=torch.float32, device=dev)
    status = torch.empty(B, dtype=torch.int32, device=dev)
    R_new = torch.empty((B, m, m), dtype=torch.float32, device=dev)
    if B > 0:
        fn = cuda_lib.function("iu_epilogue", "lmpc_iu_epilogue", _ARGTYPES)
        with torch.cuda.device(dev):
            ptrs = (t.data_ptr() for t in ins + lane_ins + [U, lam, R_new, status])
            err = fn(m, n, nth, B, *ptrs, int(refine), float(res_tol), cuda_lib.stream(dev))
        cuda_lib.check(err, "iu_epilogue kernel launch")
        LAUNCHES += 1
    return U, lam, status, R_new

