"""Batched dual active-set LDP solver: the exact float64 path.

Port of ``linearmpc_tpu/ops/dual_active_set.py`` (``_active_set_loop``,
``_transformed_bounds``, ``solve_single``/``solve_batch`` with forced
rows, ``finish_from_state``, ``polish_solution``, ``_primal_feasible``;
``_active_set_loop_iu`` is ``ops/iu.iterate_iu`` in float64). The JAX
package ``vmap``s a per-instance ``lax.while_loop``; here the batch is a
written-out leading dimension and the loop is a Python loop over the lanes
still running (``bulk.iterate``), each frozen once it is done or at its
iteration limit -- the same per-lane semantics.

Every lane solves its working-set KKT system either by gathering the
precomputed masked inverse from the subset table (m <= 12, bit i of the
table index is row i) or by a masked Cholesky factorization (LU for a
non-symmetric H). Double-sided constraints use a signed multiplier
(upper: lam >= 0, lower: lam <= 0); equality rows stay active with a
sign-free multiplier; immutable rows are never activated.

On CUDA, ``finish_from_state`` with a subset table runs the float64
instantiation of the K1 kernel (``ops/bulk.py``).
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


def solve_batch(arr: LDPArrays, thetas, lam0=None, active0=None, side0=None, *,
                max_iter: int = 500, primal_tol: float = 1e-6,
                sign_tol: float = 1e-12, use_cholesky: bool = True,
                forced_mask=None, forced_side=None) -> Solution:
    """Solve a (B, n_theta) batch in the dtype of ``arr`` with optional
    per-lane warm starts: ``solve_single`` of the JAX package without the
    high-precision continuation (the exact float64 path). ``forced_mask``/
    ``forced_side`` (B, m) clamp rows to equality at a bound, per lane."""
    dtype, dev = arr.G.dtype, arr.G.device
    thetas = torch.as_tensor(thetas, device=dev).to(dtype)
    B, m = thetas.shape[0], arr.G.shape[0]
    if m == 0:  # unconstrained: closed-form minimizer
        U, fval = _recover(arr, thetas, torch.zeros((B, 0), dtype=dtype, device=dev))
        z = torch.zeros((B, 0), dtype=dtype, device=dev)
        zb = torch.zeros((B, 0), dtype=torch.bool, device=dev)
        return Solution(U, z, zb, zb, fval, torch.zeros(B, dtype=torch.int32, device=dev),
                        torch.ones(B, dtype=torch.int32, device=dev))
    du_t, dl_t = _transformed_bounds(arr, thetas, forced_mask, forced_side)
    eq = arr.is_eq.expand(B, m)
    if forced_mask is not None:
        eq = eq | forced_mask
    lam = torch.zeros((B, m), dtype=dtype, device=dev) if lam0 is None else lam0.to(dev, dtype)
    active = eq.clone() if active0 is None else active0.to(dev) | eq
    side = (torch.ones((B, m), dtype=torch.bool, device=dev) if side0 is None
            else side0.to(dev))
    lam = torch.where(active, lam, 0.0)
    final = _active_set_loop(arr, du_t, dl_t, lam, active, side, max_iter=max_iter,
                             primal_tol=primal_tol, sign_tol=sign_tol,
                             use_cholesky=use_cholesky,
                             eq=None if forced_mask is None else eq)
    U, fval = _recover(arr, thetas, final.lam)
    feas = _primal_feasible(arr, du_t, dl_t, final.lam, final.active, final.side,
                            primal_tol)
    one = torch.ones_like(final.iters)
    status = torch.where(final.done & ~feas, -3 * one,
                         torch.where(final.done, one, -one))
    return Solution(U, final.lam, final.active, final.side, fval, final.iters, status)


def finish_from_state(arr_hi: LDPArrays, thetas, lam, active, side, iters0, *,
                      max_iter: int = 32, primal_tol: float = 1e-6,
                      sign_tol: float = 1e-11, use_cholesky: bool = True) -> Solution:
    """High-precision continuation + primal recovery from a bulk-phase
    state: each lane runs at most ``max_iter`` more iterations, counting
    from ``iters0``. With a subset table (m <= 10) this is the K1 kernel's
    float64 instantiation on CUDA (given the host copies of the masks, so
    the call makes no device sync) and its plain version on the CPU."""
    dtype, dev = arr_hi.G.dtype, arr_hi.G.device
    thetas = thetas.to(dev, dtype)
    du_t, dl_t = _transformed_bounds(arr_hi, thetas)
    active = active | arr_hi.is_eq
    iters0 = iters0.to(dev, torch.int32)
    m = arr_hi.G.shape[0]
    if arr_hi.subset_inv is not None and m <= bulk.MAX_M:
        lam_f, act_f, side_f, it, done = bulk.phase1(
            arr_hi.subset_inv, arr_hi.G, du_t, dl_t, arr_hi.is_eq_host,
            arr_hi.is_immutable_host, lam.to(dtype), active, side,
            max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol)
        final = DualState(lam_f, act_f, side_f, iters0 + it, done)
    else:
        final = _active_set_loop(arr_hi, du_t, dl_t, lam.to(dtype), active, side,
                                 max_iter=iters0 + max_iter, primal_tol=primal_tol,
                                 sign_tol=sign_tol, use_cholesky=use_cholesky,
                                 iters0=iters0)
    U, fval = _recover(arr_hi, thetas, final.lam)
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
