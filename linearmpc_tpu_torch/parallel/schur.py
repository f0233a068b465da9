"""Distributed (mp-sharded) dual active-set solving for large-m problems.

Port of ``linearmpc_tpu/parallel/schur.py`` (``make_mp_batch_solver``,
``:50-337``) on ``torch.distributed``. The constraint-row dimension is
split over the ``mp`` axis of a (dp, mp) ``DeviceMesh`` (``parallel/
mesh.py``) and the scenario batch over ``dp``:

* every rank holds the full iteration state (lam, act, side) of its dp
  slice of lanes, but only its (m/mp, m) row blocks of the ridged walk
  system ``Gs``, the polish target ``Gs_true`` and the plain ``G``;
* the masked KKT solve is conjugate gradients on the SPD masked system,
  the one operation that touches G, with the matvec (``mp_matvec``) a
  local row-block product followed by ``all_gather_into_tensor`` over the
  mp group. Row normalization (ops/ldp.py) gives the system a unit
  diagonal, so plain CG converges without a preconditioner;
* the blocking and acceptance steps are elementwise per lane and run
  replicated over mp.

The two ``lax.while_loop``s of the JAX package (the working-set walk and
the CG) are Python loops. Each exit test reads data every rank of the mp
group holds alike (gathered products and the replicated lane state), so
every rank of a group takes each exit at the same iteration and the
collectives stay matched. Both loops test their exit every iteration, as
the JAX loops do (one host sync each), so the port runs the same number
of iterations.

Deliberate difference: the polish target's ridge is 0 and the Richardson
polish takes 4 passes on every device (the JAX package's values on its CPU
backend, ``schur.py:120-133``); its TPU values, a ridge of 1e-8 and one
pass, were remedies for the TPU's emulated float64, and the card computes
float64 natively. The walk's ridge stays 1e-6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.dual_active_set import Solution
from ..ops.ldp import LDPData
from .mesh import dp_slice, gather_dp, mesh_device


def _pad_rows(a, m_pad):
    """Pad the row (constraint) dimension of a host array to m_pad."""
    a = np.asarray(a, dtype=np.float64)
    if a.shape[0] == m_pad:
        return a
    pad = [(0, m_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _first(hit, dtype):
    """The first True of each lane's row (the JAX package's cumsum rule)."""
    return hit & (torch.cumsum(hit.to(dtype), dim=-1) <= 1.0)


def make_mp_batch_solver(
    ldp: LDPData,
    mesh: DeviceMesh,
    *,
    max_iter: int = 200,
    cg_iter: int | None = None,
    primal_tol: float = 1e-6,
    sign_tol: float = 1e-9,
    dtype=torch.float64,
    ridge: float = 1e-6,
    polish_steps: int = 4,
    polish_ridge: float = 0.0,
):
    """A (dp, mp)-sharded batched LDP solver for ``ldp`` on this rank's
    device of ``mesh``.

    Returns ``solve(thetas) -> Solution``: ``thetas`` is the global (B,
    n_theta) batch, the same on every rank, with B divisible by the ``dp``
    size; every rank returns the whole batch's solution. Constraint rows are
    padded to a multiple of ``mp`` and marked immutable, which leaves the
    solution unchanged (padded rows have infinite bounds and zero coupling).
    """
    dp, mp = mesh.size(0), mesh.size(1)
    mp_group = mesh.get_group("mp")
    mp_rank = mesh.get_local_rank("mp")
    dev = mesh_device(mesh)
    m_true = ldp.m
    m = ((m_true + mp - 1) // mp) * mp
    n = ldp.n
    cg_iter = cg_iter if cg_iter is not None else min(m, 64)

    # host-side padding of the row dimension (padded rows: immutable,
    # infinite bounds, identity diagonal in the walk system so the masked
    # system stays SPD)
    Gs = np.zeros((m, m))
    Gs[:m_true, :m_true] = ldp.G + np.diag(np.asarray(ldp.rho_soft, dtype=np.float64))
    Gs[range(m_true, m), range(m_true, m)] = 1.0
    # ridge on the masked walk system (rows are G-normalized to a unit
    # diagonal, so this bounds its condition number near 1/ridge); the
    # Richardson polish against Gs_true restores the accuracy, and the KKT
    # verification uses the true primal slacks
    Gs[range(m), range(m)] += ridge
    G_plain = np.zeros((m, m))
    G_plain[:m_true, :m_true] = ldp.G
    Gs_true = Gs.copy()
    Gs_true[range(m), range(m)] -= ridge - polish_ridge

    du = _pad_rows(ldp.du, m)
    dl = _pad_rows(ldp.dl, m)
    du[m_true:] = 1e30
    dl[m_true:] = -1e30
    Dth = _pad_rows(ldp.Dth, m)
    HinvET = np.zeros((n, m))
    HinvET[:, :m_true] = ldp.HinvET
    is_eq = np.zeros(m, bool)
    is_eq[:m_true] = ldp.is_eq
    immut = np.ones(m, bool)
    immut[:m_true] = ldp.is_immutable

    cast = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev).to(dtype)
    du_c, dl_c, Dth_c = cast(du), cast(dl), cast(Dth)
    HinvET_c, Uth_c, uoff_c = cast(HinvET), cast(ldp.Uth_off), cast(ldp.u_off)
    H_c, f_c, fth_c = cast(ldp.H), cast(ldp.f), cast(ldp.f_theta)
    eq_c = torch.as_tensor(is_eq, device=dev)
    immut_c = torch.as_tensor(immut, device=dev)
    # this rank's (m/mp, m) row blocks
    rows = slice(mp_rank * (m // mp), (mp_rank + 1) * (m // mp))
    Gs_l, Gt_l, Gp_l = (cast(a[rows]) for a in (Gs, Gs_true, G_plain))
    big = 1e30
    cg_abs2 = min(sign_tol, primal_tol) ** 2 * 1e-4
    cg_rel = 1e-7

    def mp_matvec(G_local, x, act=None):
        """y = M x with M = act G act' + diag(1 - act), or plain G when
        ``act`` is None. ``x`` (b, m) replicated over mp; the local (b,
        m/mp) product, gathered over mp, restores (b, m)."""
        xin = x if act is None else act * x
        part = xin @ G_local.T
        if mp == 1:
            y = part
        else:
            out = part.new_empty((mp * part.shape[0], part.shape[1]))
            dist.all_gather_into_tensor(out, part.contiguous(), group=mp_group)
            y = out.view(mp, part.shape[0], -1).permute(1, 0, 2).reshape(part.shape[0], m)
        if act is None:
            return y
        return act * y + (1.0 - act) * x

    def cg_solve(G_local, act, rhs, x0):
        """Batched CG on the masked SPD system, warm started from x0 and
        normalized per lane by ||rhs||; runs until every lane's residual
        is below its tolerance (relative, with an absolute floor) or the
        budget ``cg_iter`` is spent."""
        scale = torch.sqrt((rhs * rhs).sum(-1, keepdim=True)).clamp_min(1e-30)
        rhs_n = rhs / scale
        x = x0 / scale
        r = rhs_n - mp_matvec(G_local, x, act)
        p = r
        rr = (r * r).sum(-1, keepdim=True)
        tol2 = torch.clamp_min(cg_abs2 / (scale * scale), cg_rel ** 2)
        i = 0
        while i < cg_iter and bool((rr > tol2).any()):
            q = mp_matvec(G_local, p, act)
            pq = (p * q).sum(-1, keepdim=True)
            alpha = torch.where(pq > 0, rr / pq.clamp_min(1e-300), 0.0)
            x = x + alpha * p
            r = r - alpha * q
            rr_new = (r * r).sum(-1, keepdim=True)
            beta = rr_new / rr.clamp_min(1e-300)
            p = r + beta * p
            rr = rr_new
            i += 1
        return x * scale

    def solve_block(thetas):
        """The walk, the polish and the verification on this rank's lanes."""
        b = thetas.shape[0]
        dt = thetas @ Dth_c.T
        du_t, dl_t = du_c + dt, dl_c + dt
        lam = torch.zeros((b, m), dtype=dtype, device=dev)
        act = eq_c.expand(b, m).clone()
        side = torch.ones((b, m), dtype=torch.bool, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        iters = torch.zeros(b, dtype=torch.int32, device=dev)

        while not bool(done.all()) and int(iters.max()) < max_iter:
            actf = act.to(dtype)
            rhs = -actf * torch.where(side, du_t, dl_t)
            lam_star = cg_solve(Gs_l, actf, rhs, actf * lam)

            sign_viol = act & ~eq_c & torch.where(side, lam_star < -sign_tol,
                                                  lam_star > sign_tol)
            has_viol = sign_viol.any(-1, keepdim=True)
            denom = lam - lam_star
            safe = torch.where(denom.abs() > 1e-30, denom, 1e-30)
            alpha_i = torch.where(sign_viol, lam / safe, big)
            alpha_min = alpha_i.amin(-1, keepdim=True)
            is_jb = _first(alpha_i <= alpha_min, dtype)
            alpha = alpha_min.clamp(0.0, 1.0)
            lam_B = torch.where(is_jb, 0.0, lam + alpha * (lam_star - lam))
            act_B = act & ~is_jb

            c = mp_matvec(Gp_l, lam_star)
            cand = ~act & ~immut_c
            v_up = torch.where(cand, -(du_t + c), -big)
            v_lo = torch.where(cand, dl_t + c, -big)
            v = torch.maximum(v_up, v_lo)
            vmax = v.amax(-1, keepdim=True)
            conv = vmax <= primal_tol
            grow = _first(v >= vmax, dtype) & ~conv
            act_A = act | grow
            side_A = torch.where(grow, v_up >= v_lo, side)
            lam_A = torch.where(act_A, lam_star, 0.0)

            keep = done[:, None]
            lam = torch.where(keep, lam, torch.where(has_viol, lam_B, lam_A))
            act = torch.where(keep, act, torch.where(has_viol, act_B, act_A))
            side = torch.where(keep, side, torch.where(has_viol, side, side_A))
            iters = iters + (~done).to(torch.int32)
            done = done | (~has_viol[:, 0] & conv[:, 0])

        # the polish: Richardson on the true system's residual, each
        # correction solved on the ridged walk system (null-space components
        # it cannot fix do not affect U: E'v = 0 for v in null(G_mask))
        actf = act.to(dtype)
        d_side = torch.where(side, du_t, dl_t)
        rhs = -actf * d_side
        lam = actf * lam
        for _ in range(polish_steps):
            lam = lam + cg_solve(Gs_l, actf, rhs - mp_matvec(Gt_l, lam, actf),
                                 torch.zeros_like(lam))

        U = uoff_c + thetas @ Uth_c.T - lam @ HinvET_c.T
        f_t = f_c + thetas @ fth_c.T
        fval = 0.5 * ((U @ H_c.T) * U).sum(-1) + (f_t * U).sum(-1)
        # KKT verification before a lane may claim optimality: the walk's
        # own tests rest on CG solves
        kkt_res = (mp_matvec(Gt_l, lam, actf) - rhs).abs().amax(-1)
        c = mp_matvec(Gp_l, lam)
        inact = ~act & ~immut_c
        primal = torch.where(inact, torch.maximum(-(du_t + c), dl_t + c), -big).amax(-1)
        sgn = torch.where(act & ~eq_c, torch.where(side, -lam, lam), -big).amax(-1)
        bad = torch.maximum(torch.maximum(primal, sgn), kkt_res)
        ok = done & (bad <= 10.0 * primal_tol)
        status = torch.where(ok, 1, -1).to(torch.int32)
        return Solution(U, lam[:, :m_true], act[:, :m_true], side[:, :m_true], fval, iters,
                        status)

    def solve(thetas) -> Solution:
        thetas = torch.as_tensor(thetas, device=dev).to(dtype)
        sol = solve_block(thetas[dp_slice(mesh, thetas.shape[0])].contiguous())
        return Solution(*(gather_dp(mesh, t) for t in sol))

    return solve
