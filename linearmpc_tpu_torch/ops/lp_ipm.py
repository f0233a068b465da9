"""Batched dense LP solver (primal-dual interior point): the feasibility
oracle of explicit-MPC enumeration, the BST build and certification.

Port of ``linearmpc_tpu/ops/lp_ipm.py``. The offline analyses solve one
small Chebyshev or support LP per candidate region; here a whole frontier
of candidates is solved at once by one fixed-shape primal-dual
path-following iteration over a batch of lanes, in float64 on the
device, with no host sync inside the loop.

Signed Chebyshev formulation: maximize r s.t. A th + ||A_i|| r <= b plus
box rows, *without* r >= 0, so every instance is strictly feasible (push
r below all slacks at the box center) and emptiness is simply r* < 0.
That removes the need for infeasibility detection inside the IPM: primal
feasibility is maintained exactly (A dx + ds = 0) from the strictly
feasible start.

Deliberate differences from the JAX package:

* every chunk runs through ``lp_ipm_batch`` on the caller's device; there
  is no NumPy twin for small chunks and no ``LINEARMPC_TPU_LP_DEVICE`` /
  ``LINEARMPC_TPU_LP_NUMPY_MAX`` switch (``lp_ipm.py:33-48``, ``:173``).
  On ``device="cpu"`` the same torch function runs on the CPU;
* no lane or row padding of a chunk (``_pad_lp``, ``:127-162``, existed to
  reuse XLA compiles): a chunk is cut to its own rows as
  ``_row_sorted_chunks`` says (at least 32), and the certificate's
  ``m_total`` is the row count actually solved, the rule of the JAX
  package's NumPy path.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import resolve_device

# lane cap per IPM call; candidate batches are chunked (sorted by their
# true row count first, so one deep candidate does not force the whole
# wave onto the fattest row count)
LP_CHUNK = 1024
SIGMA = 0.2      # centering parameter
STEP_FRAC = 0.995  # fraction-to-boundary


def lp_ipm_batch(A, b, c, x0, *, n_iter: int = 40):
    """Solve min c'x s.t. A x <= b for a batch of LPs, in float64.

    Args:
      A: (B, m, n); zero rows are valid padding when the matching b > 0.
      b: (B, m)
      c: (B, n) or (n,)
      x0: (B, n) strictly feasible starts (A x0 < b elementwise).
    All four on one device. Returns (x, obj, gap, rd) on that device:
    primal solutions, objectives, final complementarity gaps, and the final
    dual residual c + A'lam (B, n). A certified objective bound must
    account for BOTH gap and rd: the IPM ends on an iteration budget, not
    on rd.
    """
    if A.dtype != torch.float64:
        raise TypeError(f"lp_ipm_batch runs in float64, got {A.dtype}")
    B, m, n = A.shape
    c = torch.broadcast_to(c, (B, n))
    At = A.mT
    mv = lambda M, v: torch.bmm(M, v[:, :, None])[:, :, 0]

    x = x0
    s = b - mv(A, x0)
    lam = torch.ones_like(b)
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n)

    def maxstep(v, dv):
        neg = dv < 0
        t = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
        return torch.clamp(STEP_FRAC * t.amin(1, keepdim=True), max=1.0)

    for _ in range(n_iter):
        # s stays exactly primal-feasible: A dx + ds = 0 throughout
        s = torch.clamp(s, min=1e-14)                 # guard divisions
        d = lam / s
        mu = (lam * s).mean(1, keepdim=True)
        r_d = c + mv(At, lam)                         # dual residual
        rhs = -r_d - mv(At, SIGMA * mu / s - lam)
        # Newton system (A' D A) dx = rhs through a QR of W = sqrt(D) A,
        # not a Cholesky of the normal matrix: on near-duplicate rows that
        # Cholesky either emits NaNs or converges to a wrong optimum the
        # duality gap cannot see (linearmpc_tpu/ops/lp_ipm.py:88-98). The
        # sqrt(ridge) I rows, ~1e-13 of the matrix scale, only guard exact
        # rank deficiency.
        W = torch.sqrt(d)[:, :, None] * A
        tr = (W * W).sum((1, 2), keepdim=True) / n
        W_aug = torch.cat([W, torch.sqrt(1e-13 * tr + 1e-30) * eye], dim=1)
        Rq = torch.linalg.qr(W_aug, mode="r").R       # (B, n, n)
        y = torch.linalg.solve_triangular(Rq.mT, rhs[:, :, None], upper=False)
        dx = torch.linalg.solve_triangular(Rq, y, upper=True)[:, :, 0]
        ds = -mv(A, dx)
        dlam = (SIGMA * mu - lam * (s + ds)) / s

        ap = maxstep(s, ds)
        ad = maxstep(lam, dlam)
        x = x + ap * dx
        s = s + ap * ds
        lam = lam + ad * dlam
    obj = (c * x).sum(1)
    gap = (lam * s).sum(1) / m
    rd = c + mv(At, lam)
    return x, obj, gap, rd


def _run_ipm(A, b, cs, x0, n_iter, device, stats):
    """One chunk through ``lp_ipm_batch`` on ``device``; NumPy results
    (x, obj, gap, rd, m_total), m_total the rows solved."""
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)
    x, obj, gap, rd = lp_ipm_batch(put(A), put(b), put(cs), put(x0), n_iter=n_iter)
    if stats is not None:
        stats["ipm_chunks"] = stats.get("ipm_chunks", 0) + 1
        stats["ipm_lanes"] = stats.get("ipm_lanes", 0) + A.shape[0]
    return (x.cpu().numpy(), obj.cpu().numpy(), gap.cpu().numpy(), rd.cpu().numpy(),
            A.shape[1])


def _row_sorted_chunks(As):
    """Yield (index_array, m_trunc) chunks of <= LP_CHUNK lanes, sorted by
    true (non-padding) row count so each chunk can be cut to its own row
    count (at least 32). Rows are built front-packed by every caller;
    padding rows have zero norm."""
    B, m, _ = As.shape
    used = (np.linalg.norm(As, axis=2) > 1e-12).sum(axis=1)
    order = np.argsort(used, kind="stable")
    for i0 in range(0, B, LP_CHUNK):
        idx = order[i0 : i0 + LP_CHUNK]
        m_t = max(32, int(used[idx].max()) if len(idx) else 32)
        yield idx, min(m, m_t)


def support_batch(As, bs, lb, ub, cs, x0, *, n_iter: int = 45, device=None, stats=None):
    """Batched support LP: min c'th over {A th <= b} ∩ [lb, ub].

    Args:
      As: (B, m, nth) rows with zero-row padding (matching bs >= 1);
      bs: (B, m);
      lb, ub: (nth,) box;
      cs: (B, nth) per-lane objectives;
      x0: (B, nth) strictly interior starts (e.g. Chebyshev centers);
      device: where the IPM runs (None: the card);
      stats: a dict that counts ``ipm_chunks`` and ``ipm_lanes``, or None.
    Returns (val, slack_tot, gap): primal objective values (an upper bound
    on the true minimum; the certified lower bound is ``val - slack_tot``).
    ``slack_tot`` covers the full duality error: m_total * gap plus
    sum_i |rd_i| * max(|lb|,|ub|)_i (|rd' th| over the box; the IPM never
    checks rd at termination, so complementarity alone is no certificate).
    Lanes whose start is not strictly interior or whose gap stays large
    must be routed to an exact host LP.
    """
    device = resolve_device(device)
    As = np.asarray(As, dtype=np.float64)
    bs = np.asarray(bs, dtype=np.float64)
    B, m, nth = As.shape
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    cs = np.broadcast_to(np.asarray(cs, np.float64), (B, nth))
    x0 = np.asarray(x0, np.float64)

    box_A = np.zeros((2 * nth, nth))
    box_b = np.zeros(2 * nth)
    for i in range(nth):
        box_A[2 * i, i] = 1.0
        box_b[2 * i] = ub[i]
        box_A[2 * i + 1, i] = -1.0
        box_b[2 * i + 1] = -lb[i]
    box_mag = np.maximum(np.abs(lb), np.abs(ub))       # (nth,)

    val = np.zeros(B)
    slack_tot = np.zeros(B)
    gap_out = np.zeros(B)
    for idx, m_t in _row_sorted_chunks(As):
        Bc = len(idx)
        A = np.concatenate(
            [As[idx, :m_t], np.broadcast_to(box_A, (Bc, 2 * nth, nth))], axis=1)
        b = np.concatenate([bs[idx, :m_t],
                            np.broadcast_to(box_b, (Bc, 2 * nth))], axis=1)
        x, obj, gap, rd, m_total = _run_ipm(A, b, cs[idx], x0[idx], n_iter, device, stats)
        val[idx] = obj
        slack_tot[idx] = m_total * gap + (np.abs(rd) @ box_mag)
        gap_out[idx] = gap
    return val, slack_tot, gap_out


def chebyshev_lp(As_c, bs_c, lb, ub):
    """The signed Chebyshev LP of a chunk over x = [th; r]: (A, b, c, x0)
    with the box rows appended and a strictly feasible start (the box
    center, r below every slack)."""
    Bc, _m, nth = As_c.shape
    box_A = np.zeros((2 * nth, nth + 1))
    box_b = np.zeros(2 * nth)
    for i in range(nth):
        box_A[2 * i, i], box_A[2 * i, nth] = 1.0, 1.0
        box_b[2 * i] = ub[i]
        box_A[2 * i + 1, i], box_A[2 * i + 1, nth] = -1.0, 1.0
        box_b[2 * i + 1] = -lb[i]
    c = np.zeros(nth + 1)
    c[nth] = -1.0  # maximize r
    center = (lb + ub) / 2
    r_box = np.min((ub - lb) / 2)
    norms = np.linalg.norm(As_c, axis=2)          # (Bc, m)
    A = np.concatenate(
        [np.concatenate([As_c, norms[..., None]], axis=2),
         np.broadcast_to(box_A, (Bc, 2 * nth, nth + 1))], axis=1)
    b = np.concatenate([bs_c, np.broadcast_to(box_b, (Bc, 2 * nth))], axis=1)
    slack0 = bs_c - As_c @ center
    coef = np.where(norms > 1e-12, norms, 1.0)
    r_cand = np.where(norms > 1e-12, slack0 / coef, np.inf)
    r0 = np.minimum(np.min(r_cand, axis=1, initial=np.inf), r_box) - 1.0
    x0 = np.concatenate([np.broadcast_to(center, (Bc, nth)), r0[:, None]], axis=1)
    return A, b, c, x0


def chebyshev_batch(As, bs, lb, ub, *, n_iter: int = 45, device=None, stats=None):
    """Batched signed Chebyshev radius of {A th <= b} ∩ [lb, ub].

    Args:
      As: (B, m, nth) region rows, zero rows as padding;
      bs: (B, m) with padding rows' rhs >= 1;
      lb, ub: (nth,) parameter box;
      device: where the IPM runs (None: the card);
      stats: a dict that counts ``ipm_chunks`` and ``ipm_lanes``, or None.
    Returns (r, center, gap): per-lane signed inscribed-ball radius over
    the box (negative => empty intersection), the ball center (valid when
    r > 0), and the final IPM complementarity gap plus the largest dual
    residual. A stalled lane (degenerate near-parallel rows collapse the
    fraction-to-boundary step) can report a finite r far from optimal with
    a large gap: callers route lanes with ``gap`` above ~1e-9 to an exact
    host LP before trusting r.
    """
    device = resolve_device(device)
    As = np.asarray(As, dtype=np.float64)
    bs = np.asarray(bs, dtype=np.float64)
    B, m, nth = As.shape
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)

    r_out = np.zeros(B)
    cen_out = np.zeros((B, nth))
    gap_out = np.zeros(B)
    for idx, m_t in _row_sorted_chunks(As):
        A, b, c, x0 = chebyshev_lp(As[idx, :m_t], bs[idx, :m_t], lb, ub)
        x, obj, gap, rd, _mt = _run_ipm(A, b, c, x0, n_iter, device, stats)
        r_out[idx] = x[:, nth]
        cen_out[idx] = x[:, :nth]
        # fold the dual residual into the reported gap so caller
        # thresholds (route-to-host-LP above ~1e-9) see both failures
        gap_out[idx] = gap + np.max(np.abs(rd), axis=1)
    return r_out, cen_out, gap_out
