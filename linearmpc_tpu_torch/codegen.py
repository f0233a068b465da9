"""Deployment artifacts: embedded C code generation and an exported program.

Port of ``linearmpc_tpu/codegen.py``:

* ``codegen_c`` (``codegen.py:403-558``) emits a self-contained,
  allocation-free, library-free C implementation of the controller:
  parameter assembly, the LDP dual active-set solve (working-set Cholesky,
  static storage), branch-and-bound for binary rows, control recovery and
  the observer's predict/correct, in single or double precision. The
  emitter is host NumPy over the port's ``ops/ldp.py::qp2ldp``; its data
  tables and solver text are the JAX package's, apart from two flag fixes.
* ``codegen_c_explicit`` (``codegen.py:677-760``) emits the explicit
  controller's region tables, its point-location BST
  (``ExplicitMPC.bst_arrays``) and the piecewise-affine evaluator.
* ``export_compiled`` / ``load_compiled`` (``codegen.py:561-603``) save the
  batched ``solve_single`` through ``torch.export``: the program is one
  call of the custom operator ``linearmpc_tpu_torch::solve_single`` with
  the problem arrays as buffers, so the replay runs the port's kernels (K1
  for the float32 bulk phase and the float64 continuation at m <= 10, K3
  for the bulk phase with ``bulk_inverse_updates``) on a CUDA tensor and
  their plain versions on a CPU one. The operator is registered when this
  module is imported.

Deliberate differences from the JAX package, both to meet the status
contract the rest of the port keeps (1 optimal, 2 best under budget):

* a controller without binary rows returns 1 from ``mpc_compute_control``
  on an optimal solve, where the JAX package's C returns the iteration
  count, so that a plain solve could return 2 (``codegen.py:317-327``);
* the emitted branch-and-bound drops a node whose relaxation stalled (-1)
  or overflowed (-3) and then returns 2 when it has an incumbent, where
  the JAX package's C prunes such a node as infeasible and claims 1
  (``codegen.py:247``).

``export_compiled`` exports the continuous solve only: it raises for a
hybrid or lexicographic engine, whose batched path is not
``solve_single``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch


def _fmt_array(name: str, a: np.ndarray, ctype: str) -> str:
    a = np.asarray(a, dtype=np.float64).ravel()
    body = ",\n".join(f"({ctype}){x:.20g}" for x in a)
    return f"static const {ctype} {name}[{max(len(a), 1)}] = {{\n{body}\n}};\n"


def _fmt_int_array(name: str, a) -> str:
    a = np.asarray(a, dtype=int).ravel()
    body = ",".join(str(int(x)) for x in a)
    return f"static const int {name}[{max(len(a), 1)}] = {{{body}}};\n"


_C_SOLVER = r"""
/* LDP dual active-set solve, allocation-free.
 * Working set stored as index list; each iteration refactorizes the
 * active Gram block with a dense Cholesky (k <= N_DEC, static storage).
 * Same algorithm as the framework's batched TPU kernel. */

/* soft rows can exceed the decision dimension in the working set (their
 * rho regularization adds an implicit slack direction), so storage is
 * sized by the constraint count */
static c_float ws_chol[N_CON * N_CON];
static c_float ws_rhs[N_CON];
static c_float ws_lam[N_CON];
static int mpc_iters_last = 0;

#if defined(MPC_WARMSTART)
/* persistent working set across calls (reference DAQP_WARMSTART mode,
 * src/codegen.jl:167-169): the previous optimal active set is the start
 * of the next solve, so steady-state calls converge in O(1) iterations */
static int warm_ws[N_CON], warm_side[N_CON], warm_k = 0, warm_have = 0;
void mpc_reset_warmstart(void) { warm_have = 0; warm_k = 0; }
#endif

int mpc_last_iterations(void) { return mpc_iters_last; }

static int solve_ws(const c_float *dloc, int *ws, int *side, int k)
{
    int i, j, t;
    /* build G_WW (+ rho on soft diagonal) and rhs = -d_W */
    for (i = 0; i < k; i++) {
        for (j = 0; j <= i; j++)
            ws_chol[i * k + j] = MPC_G[ws[i] * N_CON + ws[j]];
        if (MPC_SOFT[ws[i]])
            ws_chol[i * k + i] += MPC_RHO[ws[i]];
        ws_rhs[i] = -dloc[2 * ws[i] + (side[i] ? 0 : 1)];
    }
    /* in-place Cholesky */
    for (i = 0; i < k; i++) {
        c_float s = ws_chol[i * k + i];
        for (t = 0; t < i; t++) s -= ws_chol[i * k + t] * ws_chol[i * k + t];
        if (s <= (c_float)1e-14) return -1;
        s = SQRT_FUN(s);
        ws_chol[i * k + i] = s;
        for (j = i + 1; j < k; j++) {
            c_float v = ws_chol[j * k + i];
            for (t = 0; t < i; t++) v -= ws_chol[j * k + t] * ws_chol[i * k + t];
            ws_chol[j * k + i] = v / s;
        }
    }
    /* forward/back substitution */
    for (i = 0; i < k; i++) {
        c_float v = ws_rhs[i];
        for (t = 0; t < i; t++) v -= ws_chol[i * k + t] * ws_lam[t];
        ws_lam[i] = v / ws_chol[i * k + i];
    }
    for (i = k - 1; i >= 0; i--) {
        c_float v = ws_lam[i];
        for (t = i + 1; t < k; t++) v -= ws_chol[t * k + i] * ws_lam[t];
        ws_lam[i] = v / ws_chol[i * k + i];
    }
    return 0;
}

/* Core solve. ``forced``: NULL, or per-row code 0 = free / 1 = hold at
 * upper / 2 = hold at lower (the branch-and-bound node mechanism --
 * forced rows behave like equality rows at the caller-clamped bound).
 * On success returns iterations taken (>= 1) and writes the LDP objective
 * value -0.5 * d_W' lam_W (the node lower bound used for pruning). */
static int solve_ldp_core(const c_float *dloc, c_float *lam,
                          const unsigned char *forced, c_float *fval)
{
    int ws[N_CON], side[N_CON];
    c_float lam_full[N_CON];
    int k = 0, it, i, j, t;

    for (i = 0; i < N_CON; i++) { lam_full[i] = (c_float)0; lam[i] = (c_float)0; }
#if defined(MPC_WARMSTART)
    if (!forced && warm_have) {
        for (i = 0; i < warm_k; i++) { ws[i] = warm_ws[i]; side[i] = warm_side[i]; }
        k = warm_k;
    } else
#endif
    {
        for (i = 0; i < N_CON; i++) {
            if (MPC_EQ[i]) { ws[k] = i; side[k] = 1; k++; }
            else if (forced && forced[i]) { ws[k] = i; side[k] = (forced[i] == 1); k++; }
        }
    }

    for (it = 0; it < MPC_ITER_LIMIT; it++) {
        if (k > 0 && solve_ws(dloc, ws, side, k)) return -2;

        /* sign check on removable multipliers */
        int blocked = 0, kb = -1;
        c_float alpha = (c_float)1;
        for (i = 0; i < k; i++) {
            if (MPC_EQ[ws[i]] || (forced && forced[ws[i]])) continue;
            c_float ls = ws_lam[i];
            int viol = side[i] ? (ls < (c_float)-MPC_SIGN_TOL)
                               : (ls > (c_float)MPC_SIGN_TOL);
            if (viol) {
                c_float denom = lam_full[ws[i]] - ls;
                c_float a = denom != (c_float)0 ? lam_full[ws[i]] / denom : (c_float)0;
                if (!blocked || a < alpha) { alpha = a; kb = i; }
                blocked = 1;
            }
        }
        if (blocked) {
            if (alpha < (c_float)0) alpha = (c_float)0;
            for (i = 0; i < k; i++) {
                int ci = ws[i];
                lam_full[ci] += alpha * (ws_lam[i] - lam_full[ci]);
            }
            lam_full[ws[kb]] = (c_float)0;
            for (i = kb; i < k - 1; i++) { ws[i] = ws[i + 1]; side[i] = side[i + 1]; }
            k--;
            continue;
        }

        for (i = 0; i < N_CON; i++) lam_full[i] = (c_float)0;
        for (i = 0; i < k; i++) lam_full[ws[i]] = ws_lam[i];

        /* most violated inactive row */
        int jbest = -1, sbest = 1;
        c_float vbest = (c_float)MPC_PRIMAL_TOL;
        for (j = 0; j < N_CON; j++) {
            if (MPC_IMMUTABLE[j]) continue;
            int inws = 0;
            for (t = 0; t < k; t++) if (ws[t] == j) { inws = 1; break; }
            if (inws) continue;
            c_float c = (c_float)0;
            for (t = 0; t < N_CON; t++) c += MPC_G[j * N_CON + t] * lam_full[t];
            c_float vu = -(dloc[2 * j] + c);      /* upper violation */
            c_float vl = dloc[2 * j + 1] + c;     /* lower violation */
            if (vu > vbest) { vbest = vu; jbest = j; sbest = 1; }
            if (vl > vbest) { vbest = vl; jbest = j; sbest = 0; }
        }
        if (jbest < 0) {
            for (i = 0; i < N_CON; i++) lam[i] = lam_full[i];
            if (fval) {
                c_float acc = (c_float)0;
                for (i = 0; i < k; i++)
                    acc += dloc[2 * ws[i] + (side[i] ? 0 : 1)] * ws_lam[i];
                *fval = (c_float)-0.5 * acc;
            }
#if defined(MPC_WARMSTART)
            if (!forced) {
                for (i = 0; i < k; i++) { warm_ws[i] = ws[i]; warm_side[i] = side[i]; }
                warm_k = k; warm_have = 1;
            }
#endif
            mpc_iters_last = it + 1;
            return it + 1; /* optimal */
        }
        if (k >= N_CON) return -3;
        ws[k] = jbest; side[k] = sbest; k++;
    }
    mpc_iters_last = MPC_ITER_LIMIT;
    return -1; /* iteration limit */
}

/* dloc holds interleaved transformed bounds: dloc[2i] = du_i, dloc[2i+1] = dl_i */
int mpc_solve_ldp(const c_float *dloc, c_float *lam)
{
    return solve_ldp_core(dloc, lam, 0, 0);
}

#if N_BINARY > 0
/* Branch and bound over dual active-set relaxations for hybrid MPC
 * (reference: DAQP_BNB path, codegen/mpc_update_qp.c:28-52 and external
 * daqp_bnb; same lockstep algorithm as ops/bnb.py). Depth-first with a
 * fixed-capacity assignment stack; a binary row is fixed by clamping both
 * of its bounds to one side and holding it in the working set. Nodes are
 * pruned on the LDP objective (a lower bound that only grows down the
 * tree; the theta-dependent offset to the QP objective is node-invariant). */
#define BNB_STACK_CAP (2 * N_BINARY + 2)
static unsigned char bnb_stack[BNB_STACK_CAP][N_BINARY]; /* 0 free, 1 up, 2 lo */

static int mpc_solve_bnb(const c_float *dloc0, c_float *lam_out)
{
    c_float dloc[2 * N_CON];
    c_float lam[N_CON];
    unsigned char forced[N_CON];
    c_float inc_fval = (c_float)1e30;
    int inc_found = 0, capped = 0, top, nodes = 0, i, b, t;

    for (i = 0; i < N_BINARY; i++) bnb_stack[0][i] = 0;
    top = 1;

    while (top > 0 && nodes < MPC_BNB_NODE_LIMIT) {
        unsigned char asgn[N_BINARY];
        c_float fval;
        int flag;
        top--;
        for (i = 0; i < N_BINARY; i++) asgn[i] = bnb_stack[top][i];
        nodes++;

        /* node bounds: clamp fixed binary rows to their side */
        for (i = 0; i < 2 * N_CON; i++) dloc[i] = dloc0[i];
        for (i = 0; i < N_CON; i++) forced[i] = 0;
        for (b = 0; b < N_BINARY; b++) {
            int row = MPC_BIN_IDX[b];
            if (asgn[b] == 1) { dloc[2 * row + 1] = dloc[2 * row]; forced[row] = 1; }
            else if (asgn[b] == 2) { dloc[2 * row] = dloc[2 * row + 1]; forced[row] = 2; }
        }

        flag = solve_ldp_core(dloc, lam, forced, &fval);
        /* a relaxation that stalled (-1) or overflowed (-3) proves nothing:
         * the node is dropped and the search no longer claims optimality */
        if (flag == -1 || flag == -3) { capped = 1; continue; }
        if (flag < 0) continue;                      /* infeasible: prune */
        if (inc_found && fval >= inc_fval) continue; /* bound: prune */

        /* most fractional unfixed binary row: largest distance to the
         * nearer viable bound (original, unclamped bounds) */
        int jb = -1, jb_b = -1, near_up = 1;
        c_float fmax = (c_float)-1e30;
        for (b = 0; b < N_BINARY; b++) {
            int row = MPC_BIN_IDX[b];
            c_float c, su, sl, f;
            if (asgn[b]) continue;
            c = (c_float)0;
            for (t = 0; t < N_CON; t++) c += MPC_G[row * N_CON + t] * lam[t];
            su = MPC_BIN_UP_FINITE[b] ? dloc0[2 * row] + c : (c_float)1e30;
            sl = MPC_BIN_LO_FINITE[b] ? -(dloc0[2 * row + 1] + c) : (c_float)1e30;
            f = su < sl ? su : sl;
            if (f > fmax) { fmax = f; jb = row; jb_b = b; near_up = (su <= sl); }
        }

        if (jb < 0 || fmax <= (c_float)MPC_BNB_BIN_TOL) {
            /* integral: incumbent update */
            if (fval < inc_fval) {
                inc_fval = fval; inc_found = 1;
                for (i = 0; i < N_CON; i++) lam_out[i] = lam[i];
            }
            continue;
        }

        /* push far side first, near side last (DFS pops near first) */
        {
            int far_viable = near_up ? MPC_BIN_LO_FINITE[jb_b] : MPC_BIN_UP_FINITE[jb_b];
            if (far_viable && top < BNB_STACK_CAP) {
                for (i = 0; i < N_BINARY; i++) bnb_stack[top][i] = asgn[i];
                bnb_stack[top][jb_b] = near_up ? 2 : 1;
                top++;
            }
            if (top < BNB_STACK_CAP) {
                for (i = 0; i < N_BINARY; i++) bnb_stack[top][i] = asgn[i];
                bnb_stack[top][jb_b] = near_up ? 1 : 2;
                top++;
            }
        }
    }
    /* 1 = proven optimal; 2 = exact incumbent but the node limit, or a
     * node whose relaxation stalled or overflowed, stopped the proof (best
     * found under budget) -- same split as the batched solvers */
    if (inc_found) return (top > 0 || capped) ? 2 : 1;
    return -4;
}
#endif /* N_BINARY > 0 */

int mpc_compute_control(c_float *control, c_float *state, c_float *reference,
                        c_float *disturbance MPC_PARAM_ARG)
{
    c_float theta[N_THETA];
    c_float dloc[2 * N_CON];
    c_float lam[N_CON];
    int i, j, flag;

    mpc_update_parameter(theta, state, reference, disturbance MPC_PARAM_PASS);

    for (i = 0; i < N_CON; i++) {
        c_float acc = (c_float)0;
        for (j = 0; j < N_THETA; j++) acc += MPC_DTH[i * N_THETA + j] * theta[j];
        dloc[2 * i] = MPC_DU[i] + acc;
        dloc[2 * i + 1] = MPC_DL[i] + acc;
    }
#if N_BINARY > 0
    flag = mpc_solve_bnb(dloc, lam);
#else
    flag = mpc_solve_ldp(dloc, lam);
    if (flag > 0) flag = 1; /* mpc_solve_ldp returns its iteration count */
#endif
    if (flag < 0) return flag;

    for (i = 0; i < N_CONTROL; i++) {
        c_float u = MPC_U_OFFSET[i];
        for (j = 0; j < N_THETA; j++) u += MPC_UTH[i * N_THETA + j] * theta[j];
        for (j = 0; j < N_CON; j++) u -= MPC_HET[i * N_CON + j] * lam[j];
        control[i] = u;
    }
    return flag; /* 1 = optimal; 2 = B&B best-under-budget */
}
"""

_C_PARAMETER = r"""
/* The previous control enters theta through the static mpc_uprev buffer;
 * closed-loop callers refresh it between steps with mpc_set_uprev (the
 * reference instead reuses the caller's control buffer as the uprev input,
 * codegen/mpc_update_parameter.c:27). */
void mpc_set_uprev(const c_float *uprev)
{
    int i;
    for (i = 0; i < N_CONTROL; i++) mpc_uprev[i] = uprev[i];
}

void mpc_update_parameter(c_float *theta, c_float *state, c_float *reference,
                          c_float *disturbance MPC_PARAM_ARG)
{
    int i, j, off = 0;
    for (i = 0; i < N_STATE; i++) theta[off++] = state[i];
#if defined(MPC_REF_CONDENSATION)
    for (i = 0; i < N_REFERENCE; i++) {
        c_float acc = (c_float)0;
        for (j = 0; j < N_REF_TRAJ; j++)
            acc += MPC_TRAJ2SETPOINT[i * N_REF_TRAJ + j] * reference[j];
        theta[off++] = acc;
    }
#else
    for (i = 0; i < N_REFERENCE; i++) theta[off++] = reference ? reference[i] : (c_float)0;
#endif
    for (i = 0; i < N_DISTURBANCE; i++) theta[off++] = disturbance ? disturbance[i] : (c_float)0;
    for (i = 0; i < N_CONTROL_PREV; i++) theta[off++] = mpc_uprev[i];
#if N_AFFINE_PARAMETER > 0
    for (i = 0; i < N_AFFINE_PARAMETER; i++)
        theta[off++] = affine_parameter ? affine_parameter[i] : (c_float)0;
#endif
}
"""

_C_OBSERVER = r"""
/* steady-state Kalman filter as flattened row-major matvecs */
int mpc_predict_state(c_float *x, c_float *u, c_float *d)
{
    c_float xn[N_OBSERVER_STATE];
    int i, j;
    for (i = 0; i < N_OBSERVER_STATE; i++) {
        c_float acc = OBS_F_OFFSET[i];
        for (j = 0; j < N_OBSERVER_STATE; j++) acc += OBS_F[i * N_OBSERVER_STATE + j] * x[j];
        for (j = 0; j < N_OBSERVER_CONTROL; j++) acc += OBS_G[i * N_OBSERVER_CONTROL + j] * u[j];
        if (d) for (j = 0; j < N_OBSERVER_DISTURBANCE; j++) acc += OBS_GD[i * N_OBSERVER_DISTURBANCE + j] * d[j];
        xn[i] = acc;
    }
    for (i = 0; i < N_OBSERVER_STATE; i++) x[i] = xn[i];
    return 0;
}

int mpc_correct_state(c_float *x, c_float *y, c_float *d)
{
    c_float inov[N_MEASUREMENT];
    int i, j;
    for (i = 0; i < N_MEASUREMENT; i++) {
        c_float acc = y[i] - OBS_H_OFFSET[i];
        for (j = 0; j < N_OBSERVER_STATE; j++) acc -= OBS_C[i * N_OBSERVER_STATE + j] * x[j];
        if (d) for (j = 0; j < N_OBSERVER_DISTURBANCE; j++) acc -= OBS_DD[i * N_OBSERVER_DISTURBANCE + j] * d[j];
        inov[i] = acc;
    }
    for (i = 0; i < N_OBSERVER_STATE; i++) {
        c_float acc = (c_float)0;
        for (j = 0; j < N_MEASUREMENT; j++) acc += OBS_K[i * N_MEASUREMENT + j] * inov[j];
        x[i] += acc;
    }
    return 0;
}
"""


def codegen_c(mpc, dir: str, *, fname: str = "mpc_workspace", float_type: str = "double",
              iter_limit: int | None = None, warm_start: bool | None = None,
              bnb_node_limit: int | None = None,
              primal_tol: float | None = None, sign_tol: float | None = None) -> str:
    """Emit self-contained C for the controller; returns the .c path.

    Mirrors the data layout of the reference's ``qp2ldp``-generated
    workspace (src/codegen.jl:239-280) but ships its own solver, including
    branch-and-bound for hybrid (binary) problems (reference DAQP_BNB,
    codegen/mpc_update_qp.c:28-52) and an optional persistent-working-set
    warm-start mode (reference DAQP_WARMSTART, src/codegen.jl:167-169).
    Unsupported combos raise like the reference (src/codegen.jl:127,210).

    Solver settings ride into the embedded C the way the reference passes
    ``opt_settings`` into DAQP.codegen (src/codegen.jl:25-28): explicit
    keyword arguments win, then ``mpc.settings.solver_opts`` (keys
    ``iter_limit``, ``primal_tol``, ``dual_tol``, ``warm_start``,
    ``bnb_node_limit``), then the defaults. ``mpc_compute_control`` returns
    1 (optimal) or 2 (best under the branch-and-bound budget), else the
    solver's negative flag.
    """
    from .ops.ldp import qp2ldp

    mpc.ensure_setup()
    _opts = dict(mpc.settings.solver_opts)
    if iter_limit is None:
        iter_limit = int(_opts.get("iter_limit", 1000))
    if warm_start is None:
        warm_start = bool(_opts.get("warm_start", False))
    if bnb_node_limit is None:
        bnb_node_limit = int(_opts.get("bnb_node_limit", 4096))
    if primal_tol is None:
        primal_tol = float(_opts.get("primal_tol", 1e-6))
    if sign_tol is None:
        sign_tol = float(_opts.get("dual_tol", 1e-11))
    if mpc.settings.disturbance_preview and mpc.state_observer is not None:
        raise ValueError("Code generation not supported for disturbance preview with a state observer.")
    # full (uncondensed) reference preview needs no special handling: the
    # reference part of theta is simply ny*Np entries copied verbatim

    ldp = qp2ldp(mpc.mpQP, soft_weight=mpc.settings.soft_weight)
    os.makedirs(dir, exist_ok=True)
    ctype = "float" if float_type in ("float", "single") else "double"
    nx, nr, nd, nuprev, np_ = mpc.get_parameter_dims()
    nth = ldp.n_theta
    m = ldp.m
    nu = mpc.model.nu
    n = ldp.n

    # control recovery: u = u_off + (Uth_off - [K 0]) theta - HinvET lam
    Uth_u = ldp.Uth_off[:nu, :].copy()
    Uth_u[:, :nx] -= mpc.K
    HET_u = ldp.HinvET[:nu, :]

    hdr = [
        "/* Generated by linearmpc_tpu_torch codegen (allocation-free, library-free). */",
        f"#ifndef {fname.upper()}_H",
        f"#define {fname.upper()}_H",
        f"typedef {ctype} c_float;",
        f"#define N_THETA {nth}",
        f"#define N_STATE {nx}",
        f"#define N_REFERENCE {nr}",
        f"#define N_DISTURBANCE {nd}",
        f"#define N_CONTROL_PREV {nuprev}",
        f"#define N_AFFINE_PARAMETER {np_}",
        f"#define N_CONTROL {nu}",
        f"#define N_CON {m}",
        f"#define N_DEC {n}",
        f"#define MPC_ITER_LIMIT {iter_limit}",
        f"#define MPC_PRIMAL_TOL {primal_tol:.17g}",
        f"#define MPC_SIGN_TOL {sign_tol:.17g}",
        f"#define N_BINARY {int(np.sum(ldp.is_binary))}",
    ]
    if warm_start:
        hdr.append("#define MPC_WARMSTART 1")
    if np.any(ldp.is_binary):
        hdr += [
            f"#define MPC_BNB_NODE_LIMIT {bnb_node_limit}",
            "#define MPC_BNB_BIN_TOL 1e-6",
        ]
    if np_ > 0:
        hdr += ["#define MPC_PARAM_ARG , c_float *affine_parameter",
                "#define MPC_PARAM_PASS , affine_parameter"]
    else:
        hdr += ["#define MPC_PARAM_ARG", "#define MPC_PARAM_PASS"]
    if ctype == "float":
        hdr += ["#include <math.h>", "#define SQRT_FUN sqrtf"]
    else:
        hdr += ["#include <math.h>", "#define SQRT_FUN sqrt"]
    if mpc.settings.reference_condensation:
        t2s = mpc.traj2setpoint
        hdr += ["#define MPC_REF_CONDENSATION 1",
                f"#define N_REF_TRAJ {t2s.shape[1]}"]
    hdr += [
        "extern c_float mpc_uprev[];",
        "void mpc_update_parameter(c_float*, c_float*, c_float*, c_float* MPC_PARAM_ARG);",
        "int mpc_solve_ldp(const c_float*, c_float*);",
        "int mpc_compute_control(c_float*, c_float*, c_float*, c_float* MPC_PARAM_ARG);",
        "int mpc_last_iterations(void);",
        "void mpc_set_uprev(const c_float*);",
    ]
    if warm_start:
        hdr.append("void mpc_reset_warmstart(void);")

    src = [f'#include "{fname}.h"', f"c_float mpc_uprev[{max(nu, 1)}];"]
    src.append(_fmt_array("MPC_G", ldp.G, "c_float"))
    src.append(_fmt_array("MPC_DTH", ldp.Dth, "c_float"))
    src.append(_fmt_array("MPC_DU", np.clip(ldp.du, -1e30, 1e30), "c_float"))
    src.append(_fmt_array("MPC_DL", np.clip(ldp.dl, -1e30, 1e30), "c_float"))
    src.append(_fmt_array("MPC_U_OFFSET", ldp.u_off[:nu], "c_float"))
    src.append(_fmt_array("MPC_UTH", Uth_u, "c_float"))
    src.append(_fmt_array("MPC_HET", HET_u, "c_float"))
    src.append(_fmt_int_array("MPC_EQ", ldp.is_eq.astype(int)))
    src.append(_fmt_int_array("MPC_IMMUTABLE", ldp.is_immutable.astype(int)))
    src.append(_fmt_int_array("MPC_SOFT", ldp.is_soft.astype(int)))
    src.append(_fmt_array("MPC_RHO", ldp.rho_soft, "c_float"))
    if np.any(ldp.is_binary):
        bin_idx = np.where(ldp.is_binary)[0]
        src.append(_fmt_int_array("MPC_BIN_IDX", bin_idx))
        src.append(_fmt_int_array("MPC_BIN_UP_FINITE", ldp.up_finite[bin_idx].astype(int)))
        src.append(_fmt_int_array("MPC_BIN_LO_FINITE", ldp.lo_finite[bin_idx].astype(int)))
    if mpc.settings.reference_condensation:
        src.append(_fmt_array("MPC_TRAJ2SETPOINT", mpc.traj2setpoint, "c_float"))
    src.append(_C_PARAMETER)
    src.append(_C_SOLVER)

    obs = mpc.state_observer
    if obs is not None:
        est = obs.estimator if hasattr(obs, "estimator") else obs
        ny_o, nx_o = est.C.shape
        nu_o = est.G.shape[1]
        nd_o = est.Gd.shape[1]
        hdr += [
            f"#define N_MEASUREMENT {ny_o}",
            f"#define N_OBSERVER_STATE {nx_o}",
            f"#define N_OBSERVER_CONTROL {nu_o}",
            f"#define N_OBSERVER_DISTURBANCE {nd_o}",
            "int mpc_predict_state(c_float*, c_float*, c_float*);",
            "int mpc_correct_state(c_float*, c_float*, c_float*);",
        ]
        src.append(_fmt_array("OBS_F", est.F, "c_float"))
        src.append(_fmt_array("OBS_G", est.G, "c_float"))
        src.append(_fmt_array("OBS_GD", est.Gd, "c_float"))
        src.append(_fmt_array("OBS_F_OFFSET", est.f_offset, "c_float"))
        src.append(_fmt_array("OBS_C", est.C, "c_float"))
        src.append(_fmt_array("OBS_DD", est.Dd, "c_float"))
        src.append(_fmt_array("OBS_H_OFFSET", est.h_offset, "c_float"))
        src.append(_fmt_array("OBS_K", est.K, "c_float"))
        src.append(_C_OBSERVER)

    hdr.append(f"#endif /* {fname.upper()}_H */")
    with open(os.path.join(dir, f"{fname}.h"), "w") as fh:
        fh.write("\n".join(hdr) + "\n")
    cpath = os.path.join(dir, f"{fname}.c")
    with open(cpath, "w") as fc:
        fc.write("\n".join(src) + "\n")
    return cpath


# -- the exported program: batched solve_single as one custom operator -----

# the dense and mask fields of ``LDPArrays`` handed to the operator, in order
# (the subset table rides beside them, the host mask copies are rebuilt)
LDP_FIELDS = ("G", "G_solve", "Dth", "du", "dl", "HinvET", "Uth_off", "u_off", "H", "f",
              "f_theta", "is_eq", "is_immutable", "is_binary", "up_finite", "lo_finite")


def _unflatten(tensors, subset_inv):
    from .ops.dual_active_set import LDPArrays

    d = dict(zip(LDP_FIELDS, tensors))
    return LDPArrays(**d, subset_inv=subset_inv, is_eq_host=d["is_eq"].cpu(),
                     is_immutable_host=d["is_immutable"].cpu())


@torch.library.custom_op("linearmpc_tpu_torch::solve_single", mutates_args=())
def solve_single_op(thetas: torch.Tensor, arrays: list[torch.Tensor],
                    subset_inv: Optional[torch.Tensor], arrays_hi: list[torch.Tensor],
                    subset_inv_hi: Optional[torch.Tensor], max_iter: int, primal_tol: float,
                    sign_tol: float, use_cholesky: bool,
                    bulk_inverse_updates: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``dual_active_set.solve_single`` on (B, n_theta) ``thetas``; the LDP
    arrays come as ``LDP_FIELDS`` lists (``arrays_hi`` empty for none).
    Returns (U, iters, status). On CUDA tensors it runs the kernels that
    ``solve_single`` launches, on CPU tensors their plain versions."""
    from .ops.dual_active_set import solve_single

    hi = _unflatten(arrays_hi, subset_inv_hi) if arrays_hi else None
    sol = solve_single(_unflatten(arrays, subset_inv), thetas, max_iter=max_iter,
                       primal_tol=primal_tol, sign_tol=sign_tol, use_cholesky=use_cholesky,
                       arr_hi=hi, bulk_inverse_updates=bulk_inverse_updates)
    return sol.U, sol.iters, sol.status


@solve_single_op.register_fake
def _solve_single_fake(thetas, arrays, subset_inv, arrays_hi, subset_inv_hi, max_iter,
                       primal_tol, sign_tol, use_cholesky, bulk_inverse_updates):
    src = arrays_hi if arrays_hi else arrays
    B, n = thetas.shape[0], src[LDP_FIELDS.index("HinvET")].shape[0]
    return (thetas.new_empty((B, n), dtype=src[0].dtype),
            thetas.new_empty(B, dtype=torch.int32), thetas.new_empty(B, dtype=torch.int32))


class _SolveProgram(torch.nn.Module):
    """The engine's batched ``solve_single`` with its arrays as buffers."""

    def __init__(self, engine):
        super().__init__()
        kw = engine._single_kw
        hi = kw["arr_hi"]
        for tag, arr in (("lo", engine.arrays), ("hi", hi)):
            for i, name in enumerate(LDP_FIELDS):
                self.register_buffer(f"{tag}_{i}", None if arr is None else getattr(arr, name))
            self.register_buffer(f"{tag}_subset", None if arr is None else arr.subset_inv)
        self.has_hi = hi is not None
        self.kw = dict(max_iter=int(kw["max_iter"]), primal_tol=float(kw["primal_tol"]),
                       sign_tol=float(kw["sign_tol"]), use_cholesky=bool(kw["use_cholesky"]),
                       bulk_inverse_updates=bool(kw["bulk_inverse_updates"]))

    def forward(self, thetas):
        lo = [getattr(self, f"lo_{i}") for i in range(len(LDP_FIELDS))]
        hi = [getattr(self, f"hi_{i}") for i in range(len(LDP_FIELDS))] if self.has_hi else []
        return solve_single_op(thetas, lo, self.lo_subset, hi, self.hi_subset, **self.kw)


def export_compiled(mpc, path: str, *, batch: int = 1024) -> dict:
    """Save the engine's batched ``solve_single`` at a fixed ``batch`` with
    ``torch.export`` (the program file at ``path``) and its metadata (at
    ``path + ".json"``); returns the metadata. ``load_compiled`` replays
    it. The program runs on the engine's device (the card unless the
    problem was set up on the CPU) and takes float64 theta where the
    engine's tier keeps it so (a float32 engine), else the engine's dtype."""
    mpc.ensure_setup()
    engine = mpc.engine
    if engine.path in ("lex", "hybrid"):
        raise ValueError(f"export_compiled exports batched solve_single; the {engine.path} "
                         "path (hierarchy or branch-and-bound) is not that")
    nth = engine.ldp.n_theta
    in_dtype = torch.float64 if engine.tier else engine.dtype
    example = torch.zeros((batch, nth), dtype=in_dtype, device=engine.device)
    program = torch.export.export(_SolveProgram(engine), (example,))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    meta = {
        "batch": batch, "n_theta": nth, "n": engine.ldp.n, "m": engine.ldp.m,
        "dtype": str(engine.dtype).removeprefix("torch."), "platform": engine.device.type,
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return meta


def load_compiled(path: str):
    """Load an ``export_compiled`` artifact; returns a callable taking
    (batch, n_theta) theta on the program's device and returning (U,
    iters, status)."""
    return torch.export.load(path).module()


_C_EXPLICIT = r"""
/* Explicit MPC point location.
 *
 * BST descent (O(depth), exact LP-classified splits -- every region that
 * intersects a leaf cell is in the leaf's list, the role of the
 * reference's ParametricDAQP-generated tree, src/codegen.jl:62-137), then
 * a scan of the <= leaf-size candidate regions. A numerically-marginal
 * miss falls back to the best-violation candidate seen, and only then to
 * the full O(R) scan. */
static c_float empc_region_violation(int r, const c_float *theta)
{
    const int row0 = EMPC_ROW_OFFSET[r];
    const int rows = EMPC_ROW_OFFSET[r + 1] - row0;
    c_float viol = (c_float)-1e30;
    int i, j;
    for (i = 0; i < rows; i++) {
        c_float acc = -EMPC_BTH[row0 + i];
        for (j = 0; j < N_THETA; j++)
            acc += EMPC_ATH[(size_t)(row0 + i) * N_THETA + j] * theta[j];
        if (acc > viol) viol = acc;
    }
    return viol;
}

int mpc_compute_control(c_float *control, c_float *state, c_float *reference,
                        c_float *disturbance MPC_PARAM_ARG)
{
    c_float theta[N_THETA];
    int r, i, j, k, best = -1;
    c_float best_viol = (c_float)1e30;

    mpc_update_parameter(theta, state, reference, disturbance MPC_PARAM_PASS);

    /* BST descent */
    int node = 0;
    for (i = 0; i <= EMPC_BST_DEPTH && node >= 0; i++) {
        c_float acc = -EMPC_BST_B[node];
        for (j = 0; j < N_THETA; j++)
            acc += EMPC_BST_A[(size_t)node * N_THETA + j] * theta[j];
        node = EMPC_BST_KIDS[2 * node + (acc > (c_float)0.0 ? 1 : 0)];
    }
    if (node < 0) {
        const int leaf = -node - 1;
        for (k = EMPC_LEAF_OFFSET[leaf]; k < EMPC_LEAF_OFFSET[leaf + 1]; k++) {
            r = EMPC_LEAF_REGIONS[k];
            c_float viol = empc_region_violation(r, theta);
            if (viol <= (c_float)1e-8) { best = r; goto found; }
            if (viol < best_viol) { best_viol = viol; best = r; }
        }
        if (best >= 0 && best_viol <= (c_float)1e-5) goto found; /* jitter */
    }

    /* full-scan fallback (theta outside every leaf candidate) */
    for (r = 0; r < N_REGIONS; r++) {
        c_float viol = empc_region_violation(r, theta);
        if (viol <= (c_float)1e-8) { best = r; break; }
        if (viol < best_viol) { best_viol = viol; best = r; }
    }
    if (best < 0) return -1;
found:
    for (i = 0; i < N_CONTROL; i++) {
        c_float u = EMPC_G[(size_t)best * N_CONTROL + i];
        for (j = 0; j < N_THETA; j++)
            u += EMPC_F[((size_t)best * N_CONTROL + i) * N_THETA + j] * theta[j];
        control[i] = u;
    }
    return 1;
}
"""


def codegen_c_explicit(empc, dir: str, *, fname: str = "empc_workspace",
                       float_type: str = "double") -> str:
    """Emit self-contained C for an explicit controller: region tables plus
    a piecewise-affine evaluator (the analog of the reference's generated
    BST evaluation, src/codegen.jl:62-137)."""
    mpc = empc.mpc
    if mpc is not None and mpc.settings.disturbance_preview and mpc.state_observer is not None:
        raise ValueError("Code generation not supported for disturbance preview with a state observer.")
    os.makedirs(dir, exist_ok=True)
    ctype = "float" if float_type in ("float", "single") else "double"
    nth, nu = empc.nth, empc.nu
    R = len(empc.regions)

    offsets = [0]
    Ath_rows, bth_rows, Fs, gs = [], [], [], []
    for cr in empc.regions:
        Ath_rows.append(cr.Ath.reshape(-1, nth) if cr.Ath.size else np.zeros((0, nth)))
        bth_rows.append(cr.bth)
        offsets.append(offsets[-1] + len(cr.bth))
        Fs.append(cr.F[:nu])
        gs.append(cr.g[:nu])

    nx, nr, nd, nuprev, np_ = (mpc.get_parameter_dims() if mpc is not None
                               else (nth, 0, 0, 0, 0))

    hdr = [
        "/* Generated by linearmpc_tpu_torch codegen (explicit MPC, allocation-free). */",
        f"#ifndef {fname.upper()}_H",
        f"#define {fname.upper()}_H",
        f"typedef {ctype} c_float;",
        "#include <stddef.h>",
        f"#define N_THETA {nth}",
        f"#define N_STATE {nx}",
        f"#define N_REFERENCE {nr}",
        f"#define N_DISTURBANCE {nd}",
        f"#define N_CONTROL_PREV {nuprev}",
        f"#define N_AFFINE_PARAMETER {np_}",
        f"#define N_CONTROL {nu}",
        f"#define N_REGIONS {R}",
    ]
    if np_ > 0:
        hdr += ["#define MPC_PARAM_ARG , c_float *affine_parameter",
                "#define MPC_PARAM_PASS , affine_parameter"]
    else:
        hdr += ["#define MPC_PARAM_ARG", "#define MPC_PARAM_PASS"]
    if mpc is not None and mpc.settings.reference_condensation:
        hdr += ["#define MPC_REF_CONDENSATION 1",
                f"#define N_REF_TRAJ {mpc.traj2setpoint.shape[1]}"]
    hdr += [
        "extern c_float mpc_uprev[];",
        "void mpc_update_parameter(c_float*, c_float*, c_float*, c_float* MPC_PARAM_ARG);",
        "int mpc_compute_control(c_float*, c_float*, c_float*, c_float* MPC_PARAM_ARG);",
        f"#endif /* {fname.upper()}_H */",
    ]

    # O(log R) point location: exact-split BST (explicit.py build_tree)
    bst_A, bst_b, bst_kids, leaf_off, leaf_reg, bst_depth, _root = empc.bst_arrays()
    hdr.insert(hdr.index(f"#define N_REGIONS {R}") + 1,
               f"#define EMPC_BST_DEPTH {int(bst_depth)}")

    src = [f'#include "{fname}.h"', f"c_float mpc_uprev[{max(nu, 1)}];"]
    src.append(_fmt_int_array("EMPC_ROW_OFFSET", offsets))
    src.append(_fmt_array("EMPC_ATH", np.vstack(Ath_rows), "c_float"))
    src.append(_fmt_array("EMPC_BTH", np.concatenate(bth_rows), "c_float"))
    src.append(_fmt_array("EMPC_F", np.stack(Fs), "c_float"))
    src.append(_fmt_array("EMPC_G", np.stack(gs), "c_float"))
    src.append(_fmt_array("EMPC_BST_A", bst_A, "c_float"))
    src.append(_fmt_array("EMPC_BST_B", np.where(np.isfinite(bst_b), bst_b, 1e30),
                          "c_float"))
    src.append(_fmt_int_array("EMPC_BST_KIDS", bst_kids.ravel()))
    src.append(_fmt_int_array("EMPC_LEAF_OFFSET", leaf_off))
    src.append(_fmt_int_array("EMPC_LEAF_REGIONS",
                              leaf_reg if len(leaf_reg) else [0]))
    if mpc is not None and mpc.settings.reference_condensation:
        src.append(_fmt_array("MPC_TRAJ2SETPOINT", mpc.traj2setpoint, "c_float"))
    src.append(_C_PARAMETER)
    src.append(_C_EXPLICIT)

    with open(os.path.join(dir, f"{fname}.h"), "w") as fh:
        fh.write("\n".join(hdr) + "\n")
    cpath = os.path.join(dir, f"{fname}.c")
    with open(cpath, "w") as fc:
        fc.write("\n".join(src) + "\n")
    return cpath
