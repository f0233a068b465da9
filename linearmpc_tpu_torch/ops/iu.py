"""K3: the Goldfarb-Idnani inverse-update bulk phase of the large-m tier.

Replaces ``linearmpc_tpu/ops/pallas_iu.py::_iu_iteration_kernel`` (and the
functions that loop it, ``phase1_iu_pallas`` / ``phase1_iu_pallas_while``)
with the hand-written CUDA kernel ``csrc/iu.cu``. Each lane carries the
masked working-set inverse R (m, m) and runs the dual iteration of
``dual_active_set.py::_active_set_loop_iu``: a jump to the working-set
minimizer with a blocking step on sign violations, then a GI add step for
the most violated row (or the pending candidate of a partial step), a
dual-unbounded-ray infeasibility flag, and a rank-2 Woodbury update of R
for the one row that changed.

``iterate_iu`` is that iteration written once, batched over lanes with a
per-lane freeze; it is K3's plain version (``phase1_iu_plain``) and, in
float64, the straggler re-solve of the engine's IU tier on the CPU. Every
matvec row and dot product sums in index order without multiply-add
contraction, so on the card kernel and plain version agree bit for bit.
The row-space half of the iteration (``gi_step``, ``gi_update``) and the
Woodbury update (``woodbury``) are shared with K4's plain version
(``ops/compact_iu.py``).

``phase1_iu`` keeps ``phase1_iu_pallas_while``'s batch-major signature and
returns. On a CUDA tensor it launches the kernel (float32 or float64) or
raises; on a CPU tensor it runs the plain version. The caller passes both
``G`` (the slack matvec) and ``Gs`` (the GI columns): the float32 tier
builds ``Gs = G + diag(rho_soft + 4 eps32)`` in float32 as the Pallas
kernel does (``gram``), the float64 re-solve ``Gs = G_solve + 4 eps64 I``
as the XLA loop does. Sentinels follow the callers: big = 3e38 and
gamma_tol = 3.5e-4 in float32 (``pallas_iu.py:144``, ``:363``), big = 1e30
and gamma_tol = sqrt(eps) in float64 (``dual_active_set.py:466``, ``:538``).

``step_iu`` resumes each lane from its whole state for K iterations (the
stepper of the hybrid search's rounds); ``search_iu`` runs the whole
float32 incremental-frontier search in one launch of ``csrc/
inc_search.cu``, whose plain version is the rounds
(``bnb_frontier.IncFrontier.search_plain``).

Deliberate difference from the Pallas kernel: every blend is a select, so
a lane whose GI step length is the ``big`` sentinel keeps finite
multipliers (the kernel's ``0 * inf`` arithmetic gating gives NaN there).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib
from .bnb import BIG, BIN_TOL
from .bulk import ordered_matvec
from .dual_active_set import _masked_inverse

# kernel launches (the count a run reads to show the path went through K3),
# and those of them made through the resumable entry (``step_iu``) and
# through the branch-and-bound search entry (``search_iu``)
LAUNCHES = 0
STEP_LAUNCHES = 0
SEARCH_LAUNCHES = 0

LANES = 128
TINY = 1e-30
# the VMEM budgets of the JAX package's K3 lane rule: the IU tier's
# (pallas_iu.py:52) and the hybrid frontier's (engine.py:1286); routing
# constants here, not memory limits
VMEM_BUDGET = 12 * 2**20
FRONTIER_BUDGET = 20 * 2**20


class IUState(NamedTuple):
    lam: torch.Tensor        # (B, m)
    act: torch.Tensor        # (B, m) bool
    side: torch.Tensor       # (B, m) bool
    pend: torch.Tensor       # (B,) int64 pending candidate row, -1 for none
    pend_side: torch.Tensor  # (B,) bool
    iters: torch.Tensor      # (B,) int32
    done: torch.Tensor       # (B,) bool
    infeas: torch.Tensor     # (B,) bool
    R: torch.Tensor          # (B, m, m) carried masked working-set inverse


def sentinels(dtype) -> tuple[float, float]:
    """(big, gamma_tol) of the iteration in ``dtype``."""
    if dtype == torch.float32:
        return 3.0e38, 3.5e-4
    return 1.0e30, float(np.sqrt(np.finfo(np.float64).eps))


def gram(ldp, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, Gs) of the GI kernels in ``dtype``: float32 as the Pallas
    kernels build them (``Gs = G32 + diag(f32(rho_soft + 4 eps32))``),
    float64 as the XLA loops do (``Gs = G_solve + 4 eps64 I``)."""
    G = np.asarray(ldp.G, np.float64)
    rho = np.asarray(ldp.rho_soft, np.float64)
    if dtype == torch.float32:
        G32 = torch.as_tensor(G, device=device).to(torch.float32)
        softd = torch.as_tensor(rho + 4 * np.finfo(np.float32).eps, device=device)
        return G32, G32 + torch.diag(softd.to(torch.float32))
    G64 = torch.as_tensor(G, device=device)
    Gsolve = torch.as_tensor(G + np.diag(rho), device=device)
    eye = torch.eye(G.shape[0], dtype=torch.float64, device=device)
    return G64, Gsolve + 4.0 * np.finfo(np.float64).eps * eye


def iu_max_chunk_lanes(m: int, budget: int = VMEM_BUDGET) -> int:
    """The JAX package's VMEM-fit rule for K3 (``pallas_iu.py:52-64``). In
    the port it is a routing rule only: the IU tier takes m where it is at
    least 128 with ``VMEM_BUDGET`` (m <= 52), the hybrid frontier with
    ``FRONTIER_BUDGET`` (m <= 66), as the JAX package does on its
    accelerator."""
    consts = 3 * (m * m * m) * 4
    per_lane = (7 * m * m + 40 * m) * 4
    lanes = (budget - consts) // per_lane
    if lanes < LANES:
        return 0
    return min(512, (lanes // LANES) * LANES)


def init_R_batch(G_solve, act0):
    """Masked working-set inverses (B, m, m) of the initial active sets, in
    the dtype of ``G_solve`` (``pallas_iu.py:79-104``): the masked
    Cholesky inverse of ``Gs = G_solve + 4 eps I``. The Newton-Schulz steps
    the JAX package adds on the TPU (whose f32 Cholesky runs in bf16) are
    not taken, as on its CPU backend: the card's Cholesky is full precision."""
    m = G_solve.shape[0]
    eye = torch.eye(m, dtype=G_solve.dtype, device=G_solve.device)
    Gs = G_solve + 4.0 * torch.finfo(G_solve.dtype).eps * eye
    actf = act0.to(device=G_solve.device, dtype=G_solve.dtype)
    M = Gs * actf[:, :, None] * actf[:, None, :] + torch.diag_embed(1.0 - actf)
    return _masked_inverse(M)


def ordered_dot(a, b):
    """Row-batched dot product of (B, n) ``a`` and ``b``, summed in index
    order (the order of the kernels' serial sums)."""
    acc = a[:, 0] * b[:, 0]
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k] * b[:, k]
    return acc


def take(x, j):
    """x[b, j[b]] of a (B, n) tensor."""
    return x.gather(1, j[:, None])[:, 0]


def run_lanes(step, st: dict, max_iter: int, reset=None) -> dict:
    """Drive ``step`` over the lanes of ``st`` (a dict of batch-leading
    tensors with ``done``, ``infeas`` and ``iters``): every lane that is
    not done runs until it is done or has run ``max_iter`` iterations, the
    per-lane semantics of the Pallas while-loop. With ``reset``, lanes
    flagged infeasible are then reset to a cold start by ``reset(st,
    flag)`` and every lane not done runs up to ``max_iter`` more
    iterations (the ``retry_infeas`` second loop, ``pallas_iu.py:509-523``).
    ``step`` returns the fields it changes for the lanes it was given."""
    B = st["done"].shape[0]
    dev = st["done"].device
    for phase in range(2 if reset is not None else 1):
        if phase == 1:
            reset(st, st["infeas"].clone())
        count = torch.zeros(B, dtype=torch.int32, device=dev)
        while True:
            run = torch.nonzero(~st["done"] & (count < max_iter)).squeeze(1)
            if run.numel() == 0:
                break
            new = step({k: v[run] for k, v in st.items()})
            for k, v in new.items():
                st[k][run] = v
            st["iters"][run] += 1
            count[run] += 1
    return st


def gi_step(G, GsT, du, dl, eq, immut, lam, act, side, pend, pend_side, *,
            ptol, stol, gtol, big, solve) -> dict:
    """The row-space half of one GI iteration, shared by K3 and K4
    (``dual_active_set.py:493-553``). ``solve(x, dot_with=None)`` applies
    the lane's working-set inverse to a row-space vector and returns
    (result in row space, the dot product of ``dot_with`` with the result
    summed where the inverse lives: rows for K3, slots for K4)."""
    m = du.shape[1]
    idx = torch.arange(m, device=du.device)
    pending = pend >= 0
    rhs = torch.where(act, -torch.where(side, du, dl), 0.0)
    ls, _ = solve(rhs)

    # sign check on the jump target, suspended while a GI add is pending
    sv = (~pending)[:, None] & act & ~eq & torch.where(side, ls < -stol, ls > stol)
    hv = sv.any(1)
    # blocking step: the first multiplier to cross zero leaves the set
    denom = lam - ls
    safe = torch.where(denom.abs() > TINY, denom, TINY)
    alpha_i = torch.where(sv, lam / safe, big)
    jb = alpha_i.argmin(1)
    alpha = take(alpha_i, jb).clamp(0.0, 1.0)

    # working point: the jump in normal mode, the carried GI iterate
    # (which holds the pending candidate's partial multiplier) mid-add
    lb = torch.where(pending[:, None], lam, torch.where(act, ls, 0.0))
    c = ordered_matvec(G, lb)
    cand = ~act & ~immut
    v_up = torch.where(cand, -(du + c), -big)
    v_lo = torch.where(cand, dl + c, -big)
    v = torch.maximum(v_up, v_lo)
    j_new = v.argmax(1)
    conv = ~pending & (take(v, j_new) <= ptol)
    j_sel = torch.where(pending, pend, j_new)
    side_j = torch.where(pending, pend_side, take(v_up, j_new) >= take(v_lo, j_new))
    c_j = take(c, j_sel)
    viol_j = torch.where(side_j, -(take(du, j_sel) + c_j), take(dl, j_sel) + c_j)
    drop_pend = pending & (viol_j <= ptol)

    # GI step for the candidate: the direction keeps the working-set rows
    # tight while its multiplier grows
    Gcol = GsT[j_sel]
    vj = torch.where(act & (idx != j_sel[:, None]), Gcol, 0.0)
    Rvj, vRv = solve(vj, dot_with=vj)
    gamma = take(Gcol, j_sel) - vRv
    sgn = torch.where(side_j, 1.0, -1.0).to(du.dtype)
    dvec = sgn[:, None] * Rvj
    t_primal = torch.where(gamma > gtol,
                           viol_j.clamp_min(0.0) / gamma.clamp_min(gtol), big)
    valid = act & ~eq & torch.where(side, dvec > 0.0, dvec < 0.0)
    t_i = torch.where(valid, (lb / torch.where(dvec == 0.0, 1.0, dvec)).clamp_min(0.0), big)
    ib = t_i.argmin(1)
    t_dual = take(t_i, ib)
    return dict(idx=idx, hv=hv, jb=jb, alpha=alpha, ls=ls, lb=lb, conv=conv,
                j_sel=j_sel, side_j=side_j, drop_pend=drop_pend, sgn=sgn, dvec=dvec,
                ib=ib, full_add=t_primal <= t_dual, t_step=torch.minimum(t_primal, t_dual),
                live=~hv & ~conv & ~drop_pend)


def gi_update(d: dict, lam, act, side, pend, pend_side, take_step):
    """New row state, pending candidate, removal flag and changed row of
    one GI iteration from the decisions ``d`` of ``gi_step``
    (``dual_active_set.py:555-579``)."""
    idx, hv, j_sel, ib, full_add = d["idx"], d["hv"], d["j_sel"], d["ib"], d["full_add"]
    is_jsel = idx == j_sel[:, None]
    is_ib = idx == ib[:, None]
    is_jb = idx == d["jb"][:, None]
    fa, ts, hvc = full_add[:, None], take_step[:, None], hv[:, None]
    lb = d["lb"]
    lam_B = torch.where(is_jb, 0.0, lam + d["alpha"][:, None] * (d["ls"] - lam))
    lam_G = torch.where(act, lb - d["t_step"][:, None] * d["dvec"], lb)
    lam_G = torch.where(is_jsel, (take(lb, j_sel) + d["sgn"] * d["t_step"])[:, None], lam_G)
    lam_G = torch.where(is_ib & ~fa, 0.0, lam_G)
    act_G = torch.where(fa, act | is_jsel, act & ~is_ib)
    side_G = torch.where(fa & is_jsel, d["side_j"][:, None], side)
    lam_DP = torch.where(is_jsel, 0.0, lam)
    new_lam = torch.where(hvc, lam_B, torch.where(
        ts, lam_G, torch.where(d["drop_pend"][:, None], lam_DP, lb)))
    new_act = torch.where(hvc, act & ~is_jb, torch.where(ts, act_G, act))
    new_side = torch.where(hvc | ~ts, side, side_G)
    new_pend = torch.where(take_step & ~full_add, j_sel,
                           torch.where(take_step | d["drop_pend"], -1, pend))
    new_pend_side = torch.where(take_step, d["side_j"], pend_side)
    is_rem = hv | (take_step & ~full_add)
    ch = torch.where(hv, d["jb"], torch.where(full_add, j_sel, ib))
    return new_lam, new_act, new_side, new_pend, new_pend_side, is_rem, ch


def woodbury(M, ch, vcol, gjj, is_rem, changed):
    """Rank-2 Woodbury update of a carried inverse M (B, n, n) for the one
    changed row/slot ``ch`` with Gram column ``vcol`` (zero at ``ch``) and
    diagonal ``gjj``: add subtracts the correction, remove adds it
    (``dual_active_set.py:575-601``). The where-selects keep an unchanged
    lane's M, so a det ~ 0 update cannot poison it."""
    b, n, _ = M.shape
    Re = M.gather(2, ch[:, None, None].expand(b, n, 1))[:, :, 0]
    Rv = ordered_matvec(M, vcol)
    a11, a12 = take(Re, ch), take(Rv, ch)
    a21, a22 = ordered_dot(vcol, Re), ordered_dot(vcol, Rv)
    # capacitance S = C^-1 +/- U'RU with C^-1 = [[0, 1], [1, 1 - gjj]]
    S00 = torch.where(is_rem, -a11, a11)
    S01 = torch.where(is_rem, 1.0 - a12, 1.0 + a12)
    S10 = torch.where(is_rem, 1.0 - a21, 1.0 + a21)
    S11 = torch.where(is_rem, (1.0 - gjj) - a22, (1.0 - gjj) + a22)
    det = S00 * S11 - S01 * S10
    det = torch.where(det.abs() > TINY, det, TINY)[:, None]
    t0 = (S11[:, None] * Re - S10[:, None] * Rv) / det
    t1 = ((-S01)[:, None] * Re + S00[:, None] * Rv) / det
    upd = t0[:, :, None] * Re[:, None, :] + t1[:, :, None] * Rv[:, None, :]
    return torch.where(changed[:, None, None],
                       torch.where(is_rem[:, None, None], M + upd, M - upd), M)


def _cold_reset(st: dict, flag):
    """Reset flagged lanes to a cold start: empty working set and exact
    identity inverse (``pallas_iu.py:510-519``)."""
    f = flag[:, None]
    st["lam"] = torch.where(f, 0.0, st["lam"])
    st["act"] = st["act"] & ~f
    st["side"] = st["side"] | f
    st["pend"] = torch.where(flag, -1, st["pend"])
    st["done"] = st["done"] & ~flag
    st["infeas"] = st["infeas"] & ~flag
    eye = torch.eye(st["R"].shape[1], dtype=st["R"].dtype, device=flag.device)
    st["R"] = torch.where(flag[:, None, None], eye, st["R"])


def iterate_iu(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, R0, *,
               max_iter: int, primal_tol: float, sign_tol: float,
               retry_infeas: bool = False, entry=None) -> IUState:
    """The batched GI inverse-update iteration in the dtype of ``du_t``:
    each lane runs until it converges, is flagged infeasible, or has run
    ``max_iter`` iterations, from ``lam0``/``act0``/``side0`` and the
    carried inverse ``R0`` (B, m, m). ``eq`` is (m,) or per-lane (B, m).

    ``entry`` = (pend, pend_side, done, infeas) resumes each lane from that
    whole state, ``lam0`` taken as it is (a pending row's partial multiplier
    sits on an inactive row): a lane that enters done runs no iteration,
    and ``iters`` counts this call's iterations only. Without it every lane
    starts with no pending row and multipliers zero off the working set."""
    B, m = du_t.shape
    dtype, dev = du_t.dtype, du_t.device
    big, gtol = sentinels(dtype)
    G, Gs = G.to(dev, dtype), Gs.to(dev, dtype)
    GsT = Gs.T.contiguous()
    immut = immut.to(dev)
    act0 = act0.to(dev, torch.bool)
    lam0 = lam0.to(dev, dtype)
    if entry is None:
        lam0 = torch.where(act0, lam0, 0.0)
        entry = (torch.full((B,), -1, dtype=torch.int64, device=dev),
                 torch.ones(B, dtype=torch.bool, device=dev),
                 torch.zeros(B, dtype=torch.bool, device=dev),
                 torch.zeros(B, dtype=torch.bool, device=dev))
    pend, pend_side, done, infeas = entry
    st = dict(
        lam=lam0.clone(), act=act0.clone(), side=side0.to(dev, torch.bool).clone(),
        pend=pend.to(dev, torch.int64).clone(),
        pend_side=pend_side.to(dev, torch.bool).clone(),
        iters=torch.zeros(B, dtype=torch.int32, device=dev),
        done=done.to(dev, torch.bool).clone(), infeas=infeas.to(dev, torch.bool).clone(),
        R=R0.to(dev, dtype).clone(),
        du=du_t, dl=dl_t, eq=eq.to(dev).expand(B, m))

    def step(s):
        R = s["R"]

        def solve(x, dot_with=None):
            y = ordered_matvec(R, x)
            return y, None if dot_with is None else ordered_dot(dot_with, y)

        d = gi_step(G, GsT, s["du"], s["dl"], s["eq"], immut, s["lam"], s["act"],
                    s["side"], s["pend"], s["pend_side"], ptol=primal_tol,
                    stol=sign_tol, gtol=gtol, big=big, solve=solve)
        no_step = d["t_step"] >= big
        infeas_now = d["live"] & no_step
        take_step = d["live"] & ~no_step
        lam, act, side, pend, pend_side, is_rem, ch = gi_update(
            d, s["lam"], s["act"], s["side"], s["pend"], s["pend_side"], take_step)
        Gch = GsT[ch]
        vcol = torch.where(act & (d["idx"] != ch[:, None]), Gch, 0.0)
        R = woodbury(R, ch, vcol, take(Gch, ch), is_rem, d["hv"] | take_step)
        return dict(lam=lam, act=act, side=side, pend=pend, pend_side=pend_side,
                    done=(~d["hv"] & d["conv"]) | infeas_now,
                    infeas=s["infeas"] | infeas_now, R=R)

    st = run_lanes(step, st, max_iter, _cold_reset if retry_infeas else None)
    return IUState(*(st[k] for k in IUState._fields))


def phase1_iu_plain(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, R0, *,
                    max_iter: int, primal_tol: float, sign_tol: float,
                    retry_infeas: bool = False):
    """K3's plain version on any device; returns (lam, act, side, iters,
    done, infeas, R) batch-major, as ``phase1_iu``."""
    R0 = batch_inverse(R0, du_t.shape[0])
    st = iterate_iu(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, R0,
                    max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol,
                    retry_infeas=retry_infeas)
    return st.lam, st.act, st.side, st.iters, st.done, st.infeas, st.R


_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
             + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 8
             + [ctypes.c_int] + [ctypes.c_double] * 4 + [ctypes.c_int] + [ctypes.c_void_p])


def entry_inverse(inv0):
    """A GI kernel's entry inverse and its batch stride in elements: one
    (n, n) matrix, or a (B, n, n) batch whose lanes all view one matrix
    (``expand``), goes in once with stride 0; any other batch contiguous."""
    n = inv0.shape[-1]
    if inv0.dim() == 2:
        return inv0.contiguous(), 0
    if inv0.stride(0) == 0 and inv0[0].is_contiguous():
        return inv0[0], 0
    return inv0.contiguous(), n * n


def batch_inverse(inv0, B: int):
    """The entry inverse as a (B, n, n) tensor (a view for one matrix)."""
    n = inv0.shape[-1]
    return inv0.expand(B, n, n) if inv0.dim() == 2 else inv0


def check_inputs(what, dtype, dev, B, m, floats, masks):
    """Device, dtype and shape checks of a GI kernel's inputs."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, got {dtype}")
    for name, (t, shape) in floats.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, (t, shape) in masks.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must have shape {shape}, got {tuple(t.shape)}")


def _phase1_iu_cuda(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, R0, *,
                    max_iter, primal_tol, sign_tol, retry_infeas):
    global LAUNCHES
    B, m = du_t.shape
    dtype, dev = du_t.dtype, du_t.device
    eq = eq.to(dev)
    check_inputs("phase1_iu kernel", dtype, dev, B, m,
                 dict(G=(G, (m, m)), Gs=(Gs, (m, m)), dl_t=(dl_t, (B, m)),
                      lam0=(lam0, (B, m)), R0=(R0, (B, m, m))),
                 dict(act0=(act0, (B, m)), side0=(side0, (B, m)), immut=(immut, (m,)),
                      eq=(eq, (m,) if eq.dim() == 1 else (B, m))))
    big, gtol = sentinels(dtype)
    # masks go in and come out as torch.bool, one byte of 0 or 1 each, as the
    # kernel reads and writes them
    mask = lambda t: t.to(device=dev, dtype=torch.bool).contiguous()
    R0, R0_stride = entry_inverse(R0)
    ins = [G.T.contiguous(), Gs.T.contiguous(), du_t.contiguous(), dl_t.contiguous(),
           mask(eq)]
    ins2 = [mask(immut), lam0.contiguous(), mask(act0), mask(side0), R0]
    lam = torch.empty((B, m), dtype=dtype, device=dev)
    act = torch.empty((B, m), dtype=torch.bool, device=dev)
    side = torch.empty((B, m), dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    done = torch.empty(B, dtype=torch.bool, device=dev)
    infeas = torch.empty(B, dtype=torch.bool, device=dev)
    R = torch.empty((B, m, m), dtype=dtype, device=dev)
    work = torch.empty(1, dtype=torch.int32, device=dev)
    if B > 0:
        fn = cuda_lib.function("iu", "lmpc_iu", _ARGTYPES)
        with torch.cuda.device(dev):
            stream = cuda_lib.stream(dev)
            err = fn(0 if dtype == torch.float32 else 1, m, B,
                     *(t.data_ptr() for t in ins), 0 if eq.dim() == 1 else m,
                     *(t.data_ptr() for t in ins2), R0_stride,
                     *(t.data_ptr() for t in (lam, act, side, iters, done, infeas, R, work)),
                     int(max_iter), float(primal_tol), float(sign_tol), gtol, big,
                     int(bool(retry_infeas)), stream)
        cuda_lib.check(err, "phase1_iu kernel launch")
        LAUNCHES += 1
    return lam, act, side, iters, done, infeas, R


def phase1_iu(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, R0, *,
              max_iter: int, primal_tol: float, sign_tol: float,
              retry_infeas: bool = False):
    """Run the GI bulk phase; returns (lam, act, side, iters, done, infeas,
    R) batch-major, as ``phase1_iu_pallas_while``.

    ``G``/``Gs`` (m, m), ``du_t``/``dl_t``/``lam0`` (B, m) and ``R0`` (B,
    m, m), or one (m, m) entry inverse for every lane, in one float dtype;
    ``act0``/``side0`` (B, m) bool; ``eq`` (m,) or (B, m) bool and
    ``immut`` (m,) bool on any device. On CUDA the kernel runs (a shared
    entry inverse goes in once, with batch stride 0); on the CPU the plain
    version does."""
    kw = dict(max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol,
              retry_infeas=retry_infeas)
    R0 = batch_inverse(R0, du_t.shape[0])
    args = (G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, R0)
    if du_t.device.type == "cuda":
        return _phase1_iu_cuda(*args, **kw)
    if du_t.device.type == "cpu":
        return phase1_iu_plain(*args, **kw)
    raise ValueError(f"phase1_iu runs on cuda or cpu tensors, got {du_t.device}")


def step_iu_plain(G, Gs, du_t, dl_t, eq, immut, state: IUState, *, K: int,
                  primal_tol: float, sign_tol: float) -> tuple[IUState, torch.Tensor]:
    """The resumable K3 step's plain version on any device: at most ``K``
    iterations a lane from the whole state ``state``; returns the new state
    and the iterations each lane ran in this call (also its ``iters``)."""
    st = iterate_iu(G, Gs, du_t, dl_t, eq, immut, state.lam, state.act, state.side,
                    batch_inverse(state.R, du_t.shape[0]), max_iter=K,
                    primal_tol=primal_tol, sign_tol=sign_tol,
                    entry=(state.pend, state.pend_side, state.done, state.infeas))
    return st, st.iters


_STEP_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_void_p] * 10
                  + [ctypes.c_int] + [ctypes.c_double] * 4 + [ctypes.c_void_p])


def _step_iu_cuda(G, Gs, du_t, dl_t, eq, immut, state: IUState, *, K, primal_tol,
                  sign_tol):
    global LAUNCHES, STEP_LAUNCHES
    B, m = du_t.shape
    dtype, dev = du_t.dtype, du_t.device
    eq = eq.to(dev)
    check_inputs("step_iu kernel", dtype, dev, B, m,
                 dict(G=(G, (m, m)), Gs=(Gs, (m, m)), dl_t=(dl_t, (B, m)),
                      lam=(state.lam, (B, m)), R=(batch_inverse(state.R, B), (B, m, m))),
                 dict(act=(state.act, (B, m)), side=(state.side, (B, m)),
                      pend=(state.pend, (B,)), pend_side=(state.pend_side, (B,)),
                      done=(state.done, (B,)), infeas=(state.infeas, (B,)),
                      immut=(immut, (m,)), eq=(eq, (m,) if eq.dim() == 1 else (B, m))))
    big, gtol = sentinels(dtype)
    mask = lambda t: t.to(device=dev, dtype=torch.bool).contiguous()
    R0, R0_stride = entry_inverse(state.R)
    ins = [G.T.contiguous(), Gs.T.contiguous(), du_t.contiguous(), dl_t.contiguous(),
           mask(eq)]
    ins2 = [mask(immut), state.lam.contiguous(), mask(state.act), mask(state.side),
            state.pend.to(device=dev, dtype=torch.int32).contiguous(), mask(state.pend_side),
            mask(state.done), mask(state.infeas), R0]
    lam = torch.empty((B, m), dtype=dtype, device=dev)
    act = torch.empty((B, m), dtype=torch.bool, device=dev)
    side = torch.empty((B, m), dtype=torch.bool, device=dev)
    pend = torch.empty(B, dtype=torch.int32, device=dev)
    pend_side = torch.empty(B, dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    done = torch.empty(B, dtype=torch.bool, device=dev)
    infeas = torch.empty(B, dtype=torch.bool, device=dev)
    R = torch.empty((B, m, m), dtype=dtype, device=dev)
    work = torch.empty(1, dtype=torch.int32, device=dev)
    if B > 0:
        fn = cuda_lib.function("iu", "lmpc_iu_step", _STEP_ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(0 if dtype == torch.float32 else 1, m, B,
                     *(t.data_ptr() for t in ins), 0 if eq.dim() == 1 else m,
                     *(t.data_ptr() for t in ins2), R0_stride,
                     *(t.data_ptr() for t in (lam, act, side, pend, pend_side, iters, done,
                                              infeas, R, work)),
                     int(K), float(primal_tol), float(sign_tol), gtol, big,
                     cuda_lib.stream(dev))
        cuda_lib.check(err, "step_iu kernel launch")
        LAUNCHES += 1
        STEP_LAUNCHES += 1
    st = IUState(lam, act, side, pend.to(torch.int64), pend_side, iters, done, infeas, R)
    return st, iters


def step_iu(G, Gs, du_t, dl_t, eq, immut, state: IUState, *, K: int, primal_tol: float,
            sign_tol: float) -> tuple[IUState, torch.Tensor]:
    """At most ``K`` GI iterations a lane from the whole carried state
    ``state`` (the counterpart of ``make_iu_stepper``, ``pallas_iu.py:
    393-451``, batch-major, with ``(pend, pend_side)`` in place of its
    signed one-hot): a lane that enters done runs no iteration and comes
    back unchanged, ``infeas`` is sticky, there is no infeasibility retry,
    and ``eq`` may be per lane (B, m). ``state.R`` is (B, m, m) or one
    (m, m) matrix for every lane. Returns the new state and the iterations
    each lane ran in this call. On CUDA the kernel's resumable entry runs;
    on the CPU the plain version does."""
    kw = dict(K=K, primal_tol=primal_tol, sign_tol=sign_tol)
    if du_t.device.type == "cuda":
        return _step_iu_cuda(G, Gs, du_t, dl_t, eq, immut, state, **kw)
    if du_t.device.type == "cpu":
        return step_iu_plain(G, Gs, du_t, dl_t, eq, immut, state, **kw)
    raise ValueError(f"step_iu runs on cuda or cpu tensors, got {du_t.device}")


def last_plan(lib: str = "iu") -> dict:
    """The launch plan the last K3 launch of this thread chose (``csrc/
    gi_common.cuh``) in ``lib``, "iu" (``lmpc_iu`` / ``lmpc_iu_step``) or
    "inc_search" (``lmpc_iu_search``): threads a lane, lanes a block,
    blocks, matrices staged in shared memory, inverse in shared memory,
    shared-memory bytes."""
    out = (ctypes.c_int * 6)()
    cuda_lib.function(lib, "lmpc_iu_plan", [ctypes.c_void_p])(ctypes.addressof(out))
    return dict(zip(("team", "lanes_per_block", "blocks", "g_staged", "inv_in_smem",
                     "smem_bytes"), out))


@dataclasses.dataclass(frozen=True)
class IUStepper:
    """``step(du_l, dl_l, eq_l, state) -> (state, steps)``: ``K`` iterations
    of ``step_iu`` over (B, m) bounds and equality mask, for callers that own
    the outer loop (the incremental frontier B&B; ``pallas_iu.py:393``).
    Its fields are the search entry's (``search_iu``) too."""

    G: torch.Tensor
    Gs: torch.Tensor
    immut: torch.Tensor
    K: int
    primal_tol: float
    sign_tol: float

    def __call__(self, du_l, dl_l, eq_l, state):
        return step_iu(self.G, self.Gs, du_l, dl_l, eq_l, self.immut, state, K=self.K,
                       primal_tol=self.primal_tol, sign_tol=self.sign_tol)

    def plain(self, du_l, dl_l, eq_l, state):
        """The same K iterations through ``step_iu_plain`` on any device."""
        return step_iu_plain(self.G, self.Gs, du_l, dl_l, eq_l, self.immut, state, K=self.K,
                             primal_tol=self.primal_tol, sign_tol=self.sign_tol)


def make_iu_stepper(G, Gs, immut, *, K: int, primal_tol: float, sign_tol: float) -> IUStepper:
    return IUStepper(G, Gs, immut, int(K), float(primal_tol), float(sign_tol))


class SearchResult(NamedTuple):
    """What the incremental-frontier search hands ``IncFrontier.finish``,
    a lane each, with its counts."""

    inc_found: torch.Tensor   # (B,) bool
    inc_fval: torch.Tensor    # (B,) float32
    inc_active: torch.Tensor  # (B, m) bool: the incumbent's working set
    inc_side: torch.Tensor    # (B, m) bool
    nodes: torch.Tensor       # (B,) int32
    iters: torch.Tensor       # (B,) int32
    exhausted: torch.Tensor   # (B,) bool: a node hit its iteration cap
    rounds: torch.Tensor      # (B,) int32: rounds the lane was solving a node
    retries: torch.Tensor     # (B,) int32: cold ray retries


_SEARCH_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 24
                    + [ctypes.c_int] * 4 + [ctypes.c_double] * 6 + [ctypes.c_void_p])


def search_iu(step: IUStepper, du_t, dl_t, is_eq, up_finite, lo_finite, branchable, HinvET,
              H, U0, f_t, *, stack_cap: int, node_cap: int, node_limit: int) -> SearchResult:
    """The whole float32 incremental-frontier search of every lane in one
    launch of ``csrc/inc_search.cu`` (``lmpc_iu_search``): the rounds of
    ``IncFrontier`` (``step``'s K GI iterations, then the management) run
    by a warp a lane until the lane can neither solve nor pop. ``du_t``/
    ``dl_t`` (B, m) and ``U0``/``f_t`` (B, n) are the lanes' theta terms,
    ``HinvET`` (n, m) and ``H`` (n, n), all float32 on one CUDA device; the
    masks (m,) bool. Sentinels: big = 3e38 in the GI loop (``step``'s), the
    frontier's BIG = 1e30 and BIN_TOL in the management. CUDA tensors only:
    it raises on any other (the plain version is the rounds,
    ``IncFrontier.search_plain``)."""
    global LAUNCHES, SEARCH_LAUNCHES
    B, m = du_t.shape
    n = HinvET.shape[0]
    dtype, dev = du_t.dtype, du_t.device
    if dev.type != "cuda":
        raise ValueError(f"search_iu launches the CUDA kernel: its tensors must be on cuda, "
                         f"got {dev}")
    if dtype != torch.float32:
        raise TypeError(f"search_iu takes float32, got {dtype}")
    check_inputs("search_iu kernel", dtype, dev, B, m,
                 dict(G=(step.G, (m, m)), Gs=(step.Gs, (m, m)), dl_t=(dl_t, (B, m)),
                      HinvET=(HinvET, (n, m)), H=(H, (n, n)), U0=(U0, (B, n)),
                      f_t=(f_t, (B, n))),
                 dict(immut=(step.immut, (m,)), is_eq=(is_eq, (m,)),
                      up_finite=(up_finite, (m,)), lo_finite=(lo_finite, (m,)),
                      branchable=(branchable, (m,))))
    big, gtol = sentinels(dtype)
    mask = lambda t: t.to(device=dev, dtype=torch.bool).contiguous()
    ins = [step.G.T.contiguous(), step.Gs.T.contiguous(), du_t.contiguous(), dl_t.contiguous(),
           mask(is_eq), mask(step.immut), mask(up_finite), mask(lo_finite), mask(branchable),
           HinvET.contiguous(), H.contiguous(), U0.contiguous(), f_t.contiguous()]
    root_R = torch.empty((B, m, m), dtype=dtype, device=dev)
    out = SearchResult(
        inc_found=torch.empty(B, dtype=torch.bool, device=dev),
        inc_fval=torch.empty(B, dtype=dtype, device=dev),
        inc_active=torch.empty((B, m), dtype=torch.bool, device=dev),
        inc_side=torch.empty((B, m), dtype=torch.bool, device=dev),
        nodes=torch.empty(B, dtype=torch.int32, device=dev),
        iters=torch.empty(B, dtype=torch.int32, device=dev),
        exhausted=torch.empty(B, dtype=torch.bool, device=dev),
        rounds=torch.empty(B, dtype=torch.int32, device=dev),
        retries=torch.empty(B, dtype=torch.int32, device=dev))
    work = torch.empty(1, dtype=torch.int32, device=dev)
    if B > 0:
        fn = cuda_lib.function("inc_search", "lmpc_iu_search", _SEARCH_ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(m, n, B, *(t.data_ptr() for t in ins), root_R.data_ptr(),
                     *(t.data_ptr() for t in out), work.data_ptr(), step.K, int(stack_cap),
                     int(node_cap), int(node_limit), step.primal_tol, step.sign_tol, gtol, big,
                     BIG, BIN_TOL, cuda_lib.stream(dev))
        cuda_lib.check(err, "search_iu kernel launch")
        LAUNCHES += 1
        SEARCH_LAUNCHES += 1
    return out

