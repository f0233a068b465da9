"""Batched dual active-set LDP solver.

Port of ``linearmpc_tpu/ops/dual_active_set.py`` (``cold_state``,
``_active_set_loop``, ``_active_set_loop_wu``, ``_transformed_bounds``,
``solve_single`` with forced rows and its float64 continuation,
``finish_from_state``, ``polish_solution``, ``_primal_feasible``;
``_active_set_loop_iu`` is ``ops/iu.iterate_iu``). The JAX package
``vmap``s a per-instance ``lax.while_loop``; here the batch is a
written-out leading dimension and the loop is a Python loop over the lanes
still running (``bulk.iterate``), each frozen once it is done or at its
iteration limit -- the same per-lane semantics.

Every lane solves its working-set KKT system either by gathering the
precomputed masked inverse from the subset table (m <= 12, bit i of the
table index is row i) or by a masked Cholesky factorization (LU for a
non-symmetric H). Double-sided constraints use a signed multiplier
(upper: lam >= 0, lower: lam <= 0); equality rows stay active with a
sign-free multiplier; immutable rows are never activated.

``solve_single`` is batched over lanes. On CUDA its loops run the kernels
that compute them: K1 (``ops/bulk.py``, float32 or float64) wherever the
subset table fits it (m <= 10, no forced rows), and K3 (``ops/iu.py``)
for the float32 bulk phase with ``bulk_inverse_updates``. At m = 11-12,
beyond the subset cache and for an LU solve no kernel computes the loop
(the JAX package runs XLA there): the masked loop runs as torch ops on the
arrays' device. ``continue_from_state`` (the continuation of
``finish_from_state``) with a subset table is K1's float64 instantiation too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bulk
from .ldp import LDPData


class LDPArrays(NamedTuple):
    """Device-resident solver arrays in one dtype."""

    G: torch.Tensor
    G_solve: torch.Tensor  # G + rho_soft * diag(is_soft)
    Dth: torch.Tensor
    du: torch.Tensor
    dl: torch.Tensor
    HinvET: torch.Tensor
    Uth_off: torch.Tensor
    u_off: torch.Tensor
    H: torch.Tensor
    f: torch.Tensor
    f_theta: torch.Tensor
    is_eq: torch.Tensor
    is_immutable: torch.Tensor
    subset_inv: torch.Tensor | None  # (2^m, m, m) working-set inverse cache
    is_eq_host: torch.Tensor          # is_eq and is_immutable on the host, as
    is_immutable_host: torch.Tensor   # the kernels take them (no device sync)
    is_binary: torch.Tensor           # binary rows (branch-and-bound)
    up_finite: torch.Tensor           # finite upper / lower bound: a binary
    lo_finite: torch.Tensor           # row can be fixed there


class DualState(NamedTuple):
    lam: torch.Tensor     # (B, m) signed multipliers
    active: torch.Tensor  # (B, m) bool working set
    side: torch.Tensor    # (B, m) bool, True = active at upper bound
    iters: torch.Tensor   # (B,) int32
    done: torch.Tensor    # (B,) bool


class Solution(NamedTuple):
    U: torch.Tensor       # (B, n) primal decision vectors
    lam: torch.Tensor     # (B, m)
    active: torch.Tensor  # (B, m) bool
    side: torch.Tensor    # (B, m) bool
    fval: torch.Tensor    # (B,) objective values
    iters: torch.Tensor   # (B,) int32
    status: torch.Tensor  # (B,) int32: 1 optimal, -1 iteration limit, -3 infeasible


def cold_state(B: int, m: int, dtype, device):
    """(lam, active, side) of a cold start for B lanes; ``solve_single``
    activates the equality rows itself, so zeros are valid everywhere."""
    return (torch.zeros((B, m), dtype=dtype, device=device),
            torch.zeros((B, m), dtype=torch.bool, device=device),
            torch.ones((B, m), dtype=torch.bool, device=device))


def to_device_arrays(ldp: LDPData, dtype, device, subset_inv=None) -> LDPArrays:
    cast = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)
    host = lambda a: torch.as_tensor(np.asarray(a, bool))
    G = cast(ldp.G)
    G_solve = cast(ldp.G + np.diag(np.asarray(ldp.rho_soft, dtype=np.float64)))
    return LDPArrays(
        G=G, G_solve=G_solve,
        Dth=cast(ldp.Dth), du=cast(ldp.du), dl=cast(ldp.dl),
        HinvET=cast(ldp.HinvET), Uth_off=cast(ldp.Uth_off), u_off=cast(ldp.u_off),
        H=cast(ldp.H), f=cast(ldp.f), f_theta=cast(ldp.f_theta),
        is_eq=host(ldp.is_eq).to(device), is_immutable=host(ldp.is_immutable).to(device),
        subset_inv=None if subset_inv is None else cast(subset_inv),
        is_eq_host=host(ldp.is_eq), is_immutable_host=host(ldp.is_immutable),
        is_binary=host(ldp.is_binary).to(device), up_finite=host(ldp.up_finite).to(device),
        lo_finite=host(ldp.lo_finite).to(device),
    )


def _masked_solve(G_solve, act, rhs, use_cholesky: bool):
    """Solve each lane's masked working-set system (inactive rows replaced
    by identity rows) with a dtype-scaled ridge, as ``_masked_solve`` of
    the JAX package: Cholesky for symmetric problems, LU otherwise."""
    B, m = act.shape
    actf = act.to(G_solve.dtype)
    eye = torch.eye(m, dtype=G_solve.dtype, device=G_solve.device)
    Gmask = G_solve * actf[:, :, None] * actf[:, None, :] + torch.diag_embed(1.0 - actf)
    Gmask = Gmask + (100.0 * m * torch.finfo(G_solve.dtype).eps) * eye
    if use_cholesky:
        L = torch.linalg.cholesky(Gmask)
        return torch.cholesky_solve(rhs[:, :, None], L)[:, :, 0]
    return torch.linalg.solve(Gmask, rhs)


def _masked_inverse(Gmask):
    """Explicit inverse of (a batch of) symmetric masked working-set systems
    through Cholesky, with the dtype-scaled ridge of ``_masked_solve``
    (``dual_active_set.py:223-242``). A system that is not positive definite
    in its dtype gives an all-NaN inverse instead of raising, as
    ``jnp.linalg.cholesky`` does: the lane's residual is then NaN, which
    the tiers rank first for their float64 re-solves."""
    m = Gmask.shape[-1]
    eye = torch.eye(m, dtype=Gmask.dtype, device=Gmask.device)
    Gm = Gmask + (100.0 * m * torch.finfo(Gmask.dtype).eps) * eye
    L, info = torch.linalg.cholesky_ex(Gm)
    inv = torch.cholesky_solve(eye.expand_as(Gm), L)
    return torch.where((info != 0)[..., None, None], torch.nan, inv)


def _active_set_loop(arr: LDPArrays, du_t, dl_t, lam, active, side, *,
                     max_iter, primal_tol: float, sign_tol: float,
                     use_cholesky: bool, iters0=None, eq=None) -> DualState:
    """The batched masked dual active-set iteration (one precision); ``eq``
    is ``arr.is_eq`` unless a per-lane (B, m) mask is given (branch-and-bound
    nodes clamp their fixed binary rows to equality)."""
    if arr.subset_inv is not None:
        table = arr.subset_inv

        def solve(a, rhs):
            return bulk.ordered_matvec(table[bulk.mask_ids(a)], rhs)
    else:
        def solve(a, rhs):
            return _masked_solve(arr.G_solve, a, rhs, use_cholesky)

    return DualState(*bulk.iterate(
        solve, arr.G, du_t, dl_t, arr.is_eq if eq is None else eq, arr.is_immutable,
        lam, active, side,
        max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol, iters0=iters0))


def _bmv(M, v):
    """Batched (B, n, n) @ (B, n)."""
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def masked_system(Gs, actf):
    """Each lane's masked working-set system: ``Gs`` on the active block,
    identity rows and columns elsewhere."""
    return Gs * actf[:, :, None] * actf[:, None, :] + torch.diag_embed(1.0 - actf)


def woodbury_rank2(R, Re, Rv, vcol, a11, a12, gjj, drop):
    """Rank-2 Woodbury update of the ridged masked inverse ``R`` for one
    row ch joining (``drop`` False) or leaving (True) the working set:
    ``Re`` = R e_ch, ``Rv`` = R vcol with ``vcol`` the row's coupling to the
    rest of the new working set, ``a11`` = Re[ch], ``a12`` = Rv[ch] and
    ``gjj`` its ridged diagonal (``dual_active_set.py:362-381``)."""
    a21, a22 = (vcol * Re).sum(1), (vcol * Rv).sum(1)
    S00 = torch.where(drop, -a11, a11)
    S01 = torch.where(drop, 1.0 - a12, 1.0 + a12)
    S10 = torch.where(drop, 1.0 - a21, 1.0 + a21)
    S11 = torch.where(drop, (1.0 - gjj) - a22, (1.0 - gjj) + a22)
    det = S00 * S11 - S01 * S10
    det = torch.where(det.abs() > 1e-30, det, 1e-30)[:, None]
    t0 = (S11[:, None] * Re - S10[:, None] * Rv) / det
    t1 = (-S01[:, None] * Re + S00[:, None] * Rv) / det
    upd = t0[:, :, None] * Re[:, None, :] + t1[:, :, None] * Rv[:, None, :]
    return torch.where(drop[:, None, None], R + upd, R - upd)


def newton_schulz(Gs, actf, R, eye):
    """One Newton-Schulz pass R (2 I - M R) against each lane's masked
    system M of ``Gs`` on the working set ``actf`` (float (B, m))."""
    naf = actf[:, :, None]
    MR = naf * torch.matmul(Gs, naf * R) + (1.0 - naf) * R
    return torch.bmm(R, 2.0 * eye - MR)


def _active_set_loop_wu(arr: LDPArrays, du_t, dl_t, eq, immut, lam, active, side, R0, *,
                        max_iter: int, primal_tol: float, sign_tol: float, iters0=None,
                        stale_tol: float = 1e-2, ridge: float | None = None):
    """The masked-Cholesky scheme (jump to the working-set minimizer, a
    blocking step on sign violations, add the most violated row) with the
    ridged masked inverse ``R`` kept up to date by a rank-2 Woodbury update
    and one Newton-Schulz pass an iteration instead of a factorization
    (``dual_active_set.py:245-413``). ``R0`` (B, m, m) is the inverse of
    each lane's entry working set; ``ridge`` (default 100 m eps) must be
    the one ``R0`` was built with. ``eq`` is (m,) or per lane (B, m);
    ``iters0`` (B,) is where each lane's count starts, ``max_iter`` the
    limit on it.

    Two refinement steps through R sharpen the jump target; a staleness
    gate freezes a lane whose next refinement correction exceeds
    ``stale_tol`` of the target (a degenerate update can leave R garbage):
    it takes no step and keeps its R for the caller to reseed.

    Every lane computes each iteration and a lane that is done, stale or
    at its limit keeps its state (the per-lane freeze of ``bulk.iterate``).
    On the CPU the loop stops once no lane runs; on CUDA, where that check
    would sync the device, it runs ``max_iter`` iterations and never syncs.
    Returns (DualState, R, stale)."""
    dtype, dev = du_t.dtype, du_t.device
    B, m = du_t.shape
    big = 1.0e30
    eps = float(torch.finfo(dtype).eps)
    ridge = 100.0 * m * eps if ridge is None else ridge
    eye = torch.eye(m, dtype=dtype, device=dev)
    Gs = arr.G_solve.to(dtype) + ridge * eye
    GsT = Gs.T.contiguous()
    G = arr.G.to(dtype)
    idx = torch.arange(m, device=dev)
    eq = eq.to(dev).expand(B, m)
    lam = lam.to(dtype).clone()
    act, side = active.to(torch.bool).clone(), side.to(torch.bool).clone()
    R = R0.to(dtype).expand(B, m, m).clone()
    iters = (torch.zeros(B, dtype=torch.int32, device=dev) if iters0 is None
             else iters0.to(device=dev, dtype=torch.int32).clone())
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    stale = torch.zeros(B, dtype=torch.bool, device=dev)
    take = lambda x, j: x.gather(1, j[:, None])[:, 0]
    for _ in range(max_iter):
        run = ~done & ~stale & (iters < max_iter)
        if dev.type == "cpu" and not bool(run.any()):
            break
        actf = act.to(dtype)
        inact = 1.0 - actf
        rhs = torch.where(act, -torch.where(side, du_t, dl_t), 0.0)

        def apply_M(x):  # the masked system times x
            return actf * ((actf * x) @ GsT) + inact * x

        ls = _bmv(R, rhs)
        for _r in range(2):
            ls = ls + _bmv(R, rhs - apply_M(ls))
        corr = _bmv(R, apply_M(ls) - rhs)
        stale_now = corr.abs().amax(1) > stale_tol * (ls.abs().amax(1) + 1.0)

        # blocking step toward lam*: the first multiplier to cross zero leaves
        sv = act & ~eq & torch.where(side, ls < -sign_tol, ls > sign_tol)
        hv = sv.any(1)
        denom = lam - ls
        safe = torch.where(denom.abs() > 1e-30, denom, 1e-30)
        alpha_i = torch.where(sv, lam / safe, big)
        jb = alpha_i.argmin(1)
        alpha = take(alpha_i, jb).clamp(0.0, 1.0)
        is_jb = idx == jb[:, None]
        lam_B = torch.where(is_jb, 0.0, lam + alpha[:, None] * (ls - lam))

        # acceptance step: take lam*, add the most violated row
        c = ls @ G.T
        cand = ~act & ~immut
        v_up = torch.where(cand, -(du_t + c), -big)
        v_lo = torch.where(cand, dl_t + c, -big)
        v = torch.maximum(v_up, v_lo)
        j = v.argmax(1)
        conv = take(v, j) <= primal_tol
        grow = (idx == j[:, None]) & ~conv[:, None]
        act_A = act | grow
        side_A = torch.where(grow, (take(v_up, j) >= take(v_lo, j))[:, None], side)
        hvc = hv[:, None]
        new_lam = torch.where(hvc, lam_B, torch.where(act_A, ls, 0.0))
        new_act = torch.where(hvc, act & ~is_jb, act_A)
        new_side = torch.where(hvc, side, side_A)
        changed = hv | ~conv

        # rank-2 Woodbury update of R for the one changed row, then one
        # Newton-Schulz pass against the new masked system
        ch = torch.where(hv, jb, j)
        Gch = GsT[ch]
        vcol = torch.where(new_act & (idx != ch[:, None]), Gch, 0.0)
        gjj = take(Gch, ch)
        Re = R.gather(2, ch[:, None, None].expand(B, m, 1))[:, :, 0]
        Rv = _bmv(R, vcol)
        R_new = woodbury_rank2(R, Re, Rv, vcol, take(Re, ch), take(Rv, ch), gjj, hv)
        R_ns = newton_schulz(Gs, new_act.to(dtype), R_new, eye)

        # a stale lane takes no step and keeps its R
        step = run & ~stale_now
        st = step[:, None]
        lam = torch.where(st, new_lam, lam)
        act = torch.where(st, new_act, act)
        side = torch.where(st, new_side, side)
        R = torch.where((step & changed)[:, None, None], R_ns, R)
        iters = iters + step.to(torch.int32)
        done = done | (step & ~hv & conv)
        stale = stale | (run & stale_now)
    return DualState(lam, act, side, iters, done), R, stale


def _transformed_bounds(arr: LDPArrays, thetas, forced_mask=None, forced_side=None):
    """Each lane's bounds; ``forced_mask``/``forced_side`` (B, m) clamp the
    given rows to equality at the chosen bound (upper where the side is
    True), as branch-and-bound fixes binary rows (``dual_active_set.py:
    620-631``)."""
    dt = thetas.to(arr.Dth.dtype) @ arr.Dth.T
    du_t, dl_t = arr.du + dt, arr.dl + dt
    if forced_mask is not None:
        d_forced = torch.where(forced_side, du_t, dl_t)
        du_t = torch.where(forced_mask, d_forced, du_t)
        dl_t = torch.where(forced_mask, d_forced, dl_t)
    return du_t, dl_t


def _recover(arr: LDPArrays, thetas, lam):
    """Primal decision vectors and objective values of a batch."""
    U = arr.u_off + thetas @ arr.Uth_off.T - lam @ arr.HinvET.T
    f_t = arr.f + thetas @ arr.f_theta.T
    fval = 0.5 * ((U @ arr.H.T) * U).sum(1) + (f_t * U).sum(1)
    return U, fval


def _primal_feasible(arr: LDPArrays, du_t, dl_t, lam, act, side, primal_tol):
    """Sound converged-point check covering ACTIVE rows, which the loop's
    candidate test never sees: on a primal-infeasible instance the masked
    system converges to a pseudo-solution whose working-set residual is
    O(violation), not ~0 (``dual_active_set.py:757-776``)."""
    actf = act.to(lam.dtype)
    d_side = torch.where(side, du_t, dl_t)
    res_act = actf * ((lam * actf) @ arr.G_solve.T) + actf * d_side
    scale = 1.0 + (actf * d_side).abs().amax(1)
    c = lam @ arr.G.T
    inact = ~act & ~arr.is_immutable
    viol_in = torch.where(inact, torch.maximum(-(du_t + c), dl_t + c), 0.0).amax(1)
    return ((res_act.abs().amax(1) <= 10.0 * primal_tol * scale)
            & (viol_in <= 10.0 * primal_tol * (1.0 + c.abs().amax(1))))


def _k1_eligible(arr: LDPArrays, forced_mask) -> bool:
    """Whether K1 computes ``arr``'s loop: a subset table the kernel takes
    (m <= 10) and the arrays' own equality rows (K1 takes one host mask)."""
    return arr.subset_inv is not None and arr.G.shape[0] <= bulk.MAX_M and forced_mask is None


def _k1_loop(arr: LDPArrays, du_t, dl_t, lam, act, side, iters0, limit: int, *,
             primal_tol: float, sign_tol: float) -> DualState:
    """The subset-table loop through ``bulk.phase1`` (K1 on CUDA, its plain
    version on the CPU), each lane run on from (lam, act, side) until it is
    done or its count, from ``iters0`` (an int shared by every lane, or
    (B,)), reaches ``limit``. K1 takes one iteration budget a launch: where
    every lane starts from the same count (the bulk phase, a single lane)
    that is one launch and no host check. Otherwise lanes with different
    counts take a launch per distinct budget (the iteration depends on
    (lam, act, side) only, so resuming a lane changes nothing), with a host
    check a launch."""
    B = du_t.shape[0]
    dev = du_t.device
    if B == 1 and torch.is_tensor(iters0):
        iters0 = int(iters0)
    if not torch.is_tensor(iters0):
        lam_r, act_r, side_r, it_r, done_r = bulk.phase1(
            arr.subset_inv, arr.G, du_t.contiguous(), dl_t.contiguous(), arr.is_eq_host,
            arr.is_immutable_host, lam.contiguous(), act.contiguous(), side.contiguous(),
            max_iter=limit - iters0, primal_tol=primal_tol, sign_tol=sign_tol)
        return DualState(lam_r, act_r, side_r, it_r + iters0, done_r)
    lam, act, side = lam.clone(), act.clone(), side.clone()
    iters = iters0.to(device=dev, dtype=torch.int32).clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        run = torch.nonzero(~done & (iters < limit)).squeeze(1)
        if run.numel() == 0:
            break
        budget = int(limit - iters[run].max())
        lam_r, act_r, side_r, it_r, done_r = bulk.phase1(
            arr.subset_inv, arr.G, du_t[run].contiguous(), dl_t[run].contiguous(),
            arr.is_eq_host, arr.is_immutable_host, lam[run].contiguous(),
            act[run].contiguous(), side[run].contiguous(), max_iter=budget,
            primal_tol=primal_tol, sign_tol=sign_tol)
        lam[run], act[run], side[run] = lam_r, act_r, side_r
        iters[run] += it_r
        done[run] = done_r
    return DualState(lam, act, side, iters, done)


def solve_single(arr: LDPArrays, thetas, lam0=None, active0=None, side0=None, *,
                 max_iter: int = 500, primal_tol: float = 1e-6, sign_tol: float = 1e-12,
                 forced_mask=None, forced_side=None, use_cholesky: bool = True,
                 arr_hi: LDPArrays | None = None,
                 bulk_inverse_updates: bool = False) -> Solution:
    """Solve a (B, n_theta) batch of LDP instances with optional per-lane
    warm starts (``dual_active_set.py:633-754``, batched).

    ``forced_mask``/``forced_side`` (B, m) clamp the given rows to equality
    at the chosen bound (upper where the side is True), the mechanism
    branch-and-bound fixes binary rows with. ``use_cholesky=False`` solves
    a non-symmetric H's working sets by LU.

    Without ``arr_hi``, one loop in the dtype of ``arr`` (the exact path
    when that is float64); status -3 where a dual ray was found or a
    converged point fails ``_primal_feasible``. With ``arr_hi`` (float64),
    the bulk phase is capped at 2 m + 16 iterations, then a float64
    continuation runs on from its state to ``max_iter + 16`` iterations at
    ``min(primal_tol, 1e-6)`` and sign_tol 1e-11; status 1 where it converged to a feasible point, -3 where it
    converged to an infeasible one, -1 otherwise. ``bulk_inverse_updates``
    runs the bulk phase as the GI inverse-update loop (K3) where there is
    no subset table. theta keeps its precision for the continuation; only
    the bulk phase rounds it to ``arr``'s dtype."""
    from . import iu

    dtype, dev = arr.G.dtype, arr.G.device
    thetas = torch.as_tensor(thetas, device=dev)
    B, m = thetas.shape[0], arr.G.shape[0]
    if m == 0:  # unconstrained: the closed-form minimizer
        src = arr if arr_hi is None else arr_hi
        U, fval = _recover(src, thetas.to(src.G.dtype), torch.zeros(
            (B, 0), dtype=src.G.dtype, device=dev))
        z = torch.zeros((B, 0), dtype=dtype, device=dev)
        zb = torch.zeros((B, 0), dtype=torch.bool, device=dev)
        return Solution(U, z, zb, zb, fval, torch.zeros(B, dtype=torch.int32, device=dev),
                        torch.ones(B, dtype=torch.int32, device=dev))
    theta_lo = thetas.to(dtype)
    du_t, dl_t = _transformed_bounds(arr, theta_lo, forced_mask, forced_side)
    eq = arr.is_eq.expand(B, m)
    if forced_mask is not None:
        eq = eq | forced_mask
    cold = cold_state(B, m, dtype, dev)
    lam = cold[0] if lam0 is None else lam0.to(dev, dtype)
    active = (cold[1] if active0 is None else active0.to(dev)) | eq
    side = cold[2] if side0 is None else side0.to(dev)
    lam = torch.where(active, lam, 0.0)
    # a capped bulk phase where a continuation follows: a rare low-precision
    # cycle must not stall the batch, the float64 loop finishes it
    cap = max_iter if arr_hi is None else min(max_iter, 2 * m + 16)
    kw = dict(primal_tol=primal_tol, sign_tol=sign_tol)
    infeas = torch.zeros(B, dtype=torch.bool, device=dev)
    if bulk_inverse_updates and arr.subset_inv is None:
        Gs = arr.G_solve + 4.0 * torch.finfo(dtype).eps * torch.eye(m, dtype=dtype, device=dev)
        lam_b, act_b, side_b, it_b, done_b, infeas, _R = iu.phase1_iu(
            arr.G, Gs, du_t.contiguous(), dl_t.contiguous(),
            arr.is_eq if forced_mask is None else eq, arr.is_immutable,
            lam.contiguous(), active.contiguous(), side.contiguous(),
            iu.init_R_batch(arr.G_solve, active), max_iter=cap, **kw)
        final = DualState(lam_b, act_b, side_b, it_b, done_b)
    elif _k1_eligible(arr, forced_mask):
        final = _k1_loop(arr, du_t, dl_t, lam, active, side, 0, cap, **kw)
    else:
        final = _active_set_loop(arr, du_t, dl_t, lam, active, side, max_iter=cap,
                                 use_cholesky=use_cholesky,
                                 eq=None if forced_mask is None else eq, **kw)

    if arr_hi is None:
        U, fval = _recover(arr, theta_lo, final.lam)
        feas = _primal_feasible(arr, du_t, dl_t, final.lam, final.active, final.side,
                                primal_tol)
        one = torch.ones_like(final.iters)
        status = torch.where(infeas | (final.done & ~feas), -3 * one,
                             torch.where(final.done, one, -one))
        return Solution(U, final.lam, final.active, final.side, fval, final.iters, status)

    # the float64 continuation from the bulk phase's state
    th_hi = thetas.to(arr_hi.G.dtype)
    du_h, dl_h = _transformed_bounds(arr_hi, th_hi, forced_mask, forced_side)
    lam_h = final.lam.to(arr_hi.G.dtype)
    kw_hi = dict(primal_tol=min(primal_tol, 1e-6), sign_tol=1e-11)
    limit = max_iter + 16
    if _k1_eligible(arr_hi, forced_mask):
        final = _k1_loop(arr_hi, du_h, dl_h, lam_h, final.active, final.side, final.iters,
                         limit, **kw_hi)
    else:
        final = _active_set_loop(arr_hi, du_h, dl_h, lam_h, final.active, final.side,
                                 max_iter=limit, use_cholesky=use_cholesky,
                                 iters0=final.iters,
                                 eq=None if forced_mask is None else eq, **kw_hi)
    U, fval = _recover(arr_hi, th_hi, final.lam)
    feas = _primal_feasible(arr_hi, du_h, dl_h, final.lam, final.active, final.side,
                            primal_tol)
    one = torch.ones_like(final.iters)
    status = torch.where(final.done & feas, one, torch.where(final.done, -3 * one, -one))
    return Solution(U, final.lam, final.active, final.side, fval, final.iters, status)


def continue_from_state(arr_hi: LDPArrays, thetas, lam, active, side, iters0, *,
                        max_iter: int = 32, primal_tol: float = 1e-6,
                        sign_tol: float = 1e-11, use_cholesky: bool = True) -> DualState:
    """High-precision continuation of a bulk-phase state: each lane runs at
    most ``max_iter`` more iterations, counting from ``iters0``. With a
    subset table (m <= 10) this is the K1 kernel's float64 instantiation on
    CUDA (given the host copies of the masks, so the call makes no device
    sync) and its plain version on the CPU."""
    dtype, dev = arr_hi.G.dtype, arr_hi.G.device
    du_t, dl_t = _transformed_bounds(arr_hi, thetas.to(dev, dtype))
    if arr_hi.is_eq_host.any():
        active = active | arr_hi.is_eq
    iters0 = iters0.to(dev, torch.int32)
    m = arr_hi.G.shape[0]
    if arr_hi.subset_inv is not None and m <= bulk.MAX_M:
        lam_f, act_f, side_f, it, done = bulk.phase1(
            arr_hi.subset_inv, arr_hi.G, du_t, dl_t, arr_hi.is_eq_host,
            arr_hi.is_immutable_host, lam.to(dtype), active, side,
            max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol)
        return DualState(lam_f, act_f, side_f, iters0 + it, done)
    return _active_set_loop(arr_hi, du_t, dl_t, lam.to(dtype), active, side,
                            max_iter=iters0 + max_iter, primal_tol=primal_tol,
                            sign_tol=sign_tol, use_cholesky=use_cholesky, iters0=iters0)


def finish_from_state(arr_hi: LDPArrays, thetas, lam, active, side, iters0, **kw) -> Solution:
    """``continue_from_state`` (``kw`` its keywords) + primal recovery."""
    final = continue_from_state(arr_hi, thetas, lam, active, side, iters0, **kw)
    U, fval = _recover(arr_hi, thetas.to(arr_hi.G.device, arr_hi.G.dtype), final.lam)
    one = torch.ones_like(final.iters)
    status = torch.where(final.done, one, -one)
    return Solution(U, final.lam, final.active, final.side, fval, final.iters, status)


def polish_solution(arr_hi: LDPArrays, thetas, active, side, *,
                    use_cholesky: bool = True, iters=None, status=None) -> Solution:
    """Direct high-precision re-solve of known working sets."""
    dtype, dev = arr_hi.G.dtype, arr_hi.G.device
    thetas = thetas.to(dev, dtype)
    du_t, dl_t = _transformed_bounds(arr_hi, thetas)
    rhs = torch.where(active, -torch.where(side, du_t, dl_t), 0.0)
    if arr_hi.subset_inv is not None:
        lam = (arr_hi.subset_inv[bulk.mask_ids(active)] @ rhs[:, :, None])[:, :, 0]
    else:
        lam = _masked_solve(arr_hi.G_solve, active, rhs, use_cholesky)
    U, fval = _recover(arr_hi, thetas, lam)
    B = thetas.shape[0]
    iters = torch.zeros(B, dtype=torch.int32, device=dev) if iters is None else iters
    status = torch.ones(B, dtype=torch.int32, device=dev) if status is None else status
    return Solution(U, lam, active, side, fval, iters, status)
