"""The comparison that decides ``correct``: what the timed path returned,
judged by the plain reference (``reference.py``) on a sample of its
answers drawn from the seed.

Every number is a worst case over the checked answers, relative to the
reference's scale, and is compared with a limit that the cell's workload
file states (``check.limits``). A checked answer whose status is not 1
counts as infinitely wrong.

* ``u_err`` (batches and single solves): max |U - U*| / (1 + |U*|) over
  the checked lanes, U* the reference's optimum. For binary rows, U* is
  the optimum over the program's own binary assignment when that
  assignment's optimum is worse than the reference's by no more than a
  float32 search can tell (``f32_tie``); a worse assignment, or a binary
  row off its bounds, is infinitely wrong.
* ``u_err`` and ``x_err`` (closed loop): at each checked step, from the
  program's own state x_k and its own applied control u_{k-1} (the
  reference follows the program step by step; u_{-1} = 0, as the
  rollout starts), the control against the reference's control at
  theta_k = [x_k; r; u_{k-1}] (r the lane's reference; the parts the
  QP's layout has), and the next state against F x_k + G u_k + f; at
  k = 0 the state against x_0.
"""

from __future__ import annotations

import numpy as np

from mpcbench import reference as ref

INF = float("inf")


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if not np.all(np.isfinite(a)):
        return INF
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def theta(qp, x, r=None, u_prev=None) -> np.ndarray:
    """theta = [x; r; u_prev] in the QP's layout (``qp.nr``, ``qp.nu_prev``)."""
    parts = [x]
    if qp.nr:
        parts.append(r)
    if qp.nu_prev:
        parts.append(u_prev)
    return np.concatenate(parts)


def f32_tie(qp, v, th) -> float:
    """The objective gap below which a float32 search cannot order two
    binary assignments: each objective, 0.5 v'Hv + f'v over n terms, is
    evaluated with a rounding error of about sqrt(n) 2^-24 times the sum
    of its terms' magnitudes; two are compared."""
    f = qp.f0 + qp.Fth @ th
    a = np.abs(v)
    terms = 0.5 * a @ np.abs(qp.H) @ a + np.abs(f) @ a
    return 2.0 * np.sqrt(len(v)) * 2.0 ** -24 * float(terms)


def _sides(qp, v, th, rows):
    """The side of each binary row in ``rows`` that v takes (True: upper),
    or None when one is off both bounds by more than 1e-6 of its span."""
    a = qp.A[rows] @ v
    lo = qp.lo0[rows] + qp.Lth[rows] @ th
    hi = qp.hi0[rows] + qp.Lth[rows] @ th
    span = np.maximum(hi - lo, 1e-300)
    up = np.abs(hi - a) <= np.abs(a - lo)
    off = np.minimum(np.abs(hi - a), np.abs(a - lo)) / span
    if not np.all(np.isfinite(a)) or np.any(off > 1e-6):
        return None
    return up


class Judge:
    def __init__(self, qp: ref.QP):
        self.qp = qp
        self.solver = ref.Solver(qp)
        self.hybrid = len(qp.bin_rows) > 0
        self.ties = []          # (gap, the tie's limit) of each lane judged by another assignment
        self.ws_sizes = []      # the reference's optimal working-set size a lane
        self.nodes = []         # its nodes a lane (branch-and-bound)
        self.work = []          # (iterations, sum of w, sum of w^2) a lane

    def optimum(self, th, rows=None, sides=None):
        """(v*, J*) at th; with ``rows``/``sides`` those binary rows held."""
        s = self.solver
        if not self.hybrid:
            v, work, _, _, st = s.solve(th)
            self.ws_sizes.append(len(work))
            return (v if st == 1 else np.full(len(v), np.nan)), None
        fix = None if rows is None else {int(r): bool(u) for r, u in zip(rows, sides)}
        before = (s.iters, s.sum_w, s.sum_w2)
        r = ref.branch_and_bound(s, th, fix)
        if rows is None:
            self.nodes.append(r.nodes)
            self.work.append(tuple(a - b for a, b in zip((s.iters, s.sum_w, s.sum_w2), before)))
        return r.v, r.J

    def lane(self, th, U, status) -> float:
        """u_err of one lane's whole decision vector."""
        th = np.asarray(th, dtype=np.float64)
        v, J = self.optimum(th)
        if status != 1:
            return INF
        if not self.hybrid:
            return _rel(U, v)
        return self._hybrid(th, U, v, J, self.qp.bin_rows)

    def _hybrid(self, th, U, v, J, rows):
        qp = self.qp
        got = _sides(qp, np.asarray(U, dtype=np.float64), th, rows)
        if got is None:
            return INF
        want = _sides(qp, v, th, rows)
        if want is not None and np.array_equal(got, want):
            return _rel(U, v)
        # another assignment: an optimum too where a float32 search cannot
        # tell it from the reference's
        v_alt, J_alt = self.optimum(th, rows, got)
        tie = f32_tie(qp, v, th)
        self.ties.append((J_alt - J, tie))
        if not np.isfinite(J_alt) or J_alt - J > tie:
            return INF
        return _rel(U, v_alt)


def judge_rollout(qp: ref.QP, plant: ref.Plant, x0, xs, us, status, steps, r=None):
    """(u_err, x_err, working-set sizes, rows added) of one closed-loop
    lane at the checked ``steps``; xs (N, nx) and us (N, nu) are the
    program's states and controls, x0 the lane's start, r its reference."""
    solver = ref.Solver(qp)
    u_err = x_err = 0.0
    sizes, added = [], []
    x_err = _rel(xs[0], x0)
    warm, prev = None, None
    for k in steps:
        x = np.asarray(xs[k], dtype=np.float64)
        u_prev = np.asarray(us[k - 1] if k > 0 else np.zeros(plant.nu), dtype=np.float64)
        th = theta(qp, x, r, u_prev)
        v, work, sides, _, st = solver.solve(th, warm=warm)
        warm = (work, sides)
        if status[k] != 1 or st != 1:
            return INF, INF, sizes, added
        u_ref = qp.Ux @ np.r_[v, th]
        u_err = max(u_err, _rel(us[k], u_ref))
        if k + 1 < len(xs):
            x_next = plant.F @ x + plant.G @ np.asarray(us[k], dtype=np.float64) + plant.f_off
            x_err = max(x_err, _rel(xs[k + 1], x_next))
        ws = set(work)
        sizes.append(len(ws))
        added.append(len(ws) if prev is None else len(ws - prev))
        prev = ws
    return u_err, x_err, sizes, added


def control_rollout(qp: ref.QP, plant: ref.Plant, x0, N: int, dtype, r=None):
    """The control in the program's place: the closed loop in ``dtype``
    (bfloat16 below the program's float32 state), tracking ``r`` and
    carrying its own previous control. Returns (xs, us, status)."""
    s = ref.Solver(qp, dtype)
    q = s.q
    F, G, f = q(plant.F), q(plant.G), q(plant.f_off)
    Ux = q(qp.Ux)
    x = q(x0)
    r = None if r is None else q(r)
    u = q(np.zeros(plant.nu))
    xs, us, st = [], [], []
    warm = None
    for _ in range(N):
        th = theta(qp, x, r, u)
        v, work, sides, _, status = s.solve(th, warm=warm)
        warm = (work, sides)
        u = q(Ux @ q(np.r_[v, th]))
        xs.append(x.astype(np.float64))
        us.append(u.astype(np.float64))
        st.append(1)
        x = q(q(F @ x) + q(G @ u) + f)
    return np.array(xs), np.array(us), np.array(st)
