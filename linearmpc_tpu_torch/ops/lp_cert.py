"""Independent primal-feasibility certificates for LDP instances.

Port of ``linearmpc_tpu/ops/lp_cert.py`` (host SciPy), over the port's
``LDPData``. The batched solvers' infeasibility verdicts (status -3) and
the NumPy oracle's occasional stalls both need an arbiter that shares no
code with either: scipy's HiGHS LP.

Reference analog: DAQP itself is the only feasibility authority in the
reference (src/utils.jl:268-283); here the production solver is the
thing under test, so the certificate must be external.
"""

from __future__ import annotations

import numpy as np


def certify_feasibility(ldp, theta) -> bool | None:
    """Exact (f64 host) feasibility verdict for one LDP instance.

    Feasibility of the QP in U-space: dl + Dth@theta <= E_n @ U <= du +
    Dth@theta over the hard rows, where E_n = HinvET' H is the normalized
    constraint matrix. Returns True (feasible), False (HiGHS-certified
    infeasible), or None when the LP solver cannot certify either way.
    """
    try:
        from scipy.optimize import linprog
    except Exception:
        return None
    E_n = np.asarray(ldp.HinvET, np.float64).T @ np.asarray(ldp.H, np.float64)
    hard = ~np.asarray(ldp.is_immutable) & ~np.asarray(ldp.is_soft)
    theta = np.asarray(theta, np.float64)
    du_t = np.asarray(ldp.du, np.float64) + np.asarray(ldp.Dth, np.float64) @ theta
    dl_t = np.asarray(ldp.dl, np.float64) + np.asarray(ldp.Dth, np.float64) @ theta
    A = np.vstack([E_n[hard], -E_n[hard]])
    b = np.concatenate([du_t[hard], -dl_t[hard]])
    keep = b < 1e19  # INF-padded one-sided rows
    res = linprog(np.zeros(E_n.shape[1]), A_ub=A[keep], b_ub=b[keep],
                  bounds=[(None, None)] * E_n.shape[1], method="highs")
    if res.status == 0:
        return True
    if res.status == 2:
        return False
    return None
