"""Explicit (multi-parametric) MPC: offline region enumeration + batched
point-location evaluation.

Port of ``linearmpc_tpu/explicit.py``. The reference delegates to the
external ParametricDAQP package (src/explicit.jl:23-48). Here the mpQP is
first made single-sided with explicit soft slacks (the math of
``make_singlesided``, src/utils.jl:329-391), then the optimal active sets
are enumerated host-side by a breadth-first walk over critical-region
neighbors; each frontier wave's emptiness checks are one batched
interior-point LP call on the device (``ops/lp_ipm.py``), borderline lanes
confirmed by HiGHS on the host. Each region stores its polyhedron and
affine feedback.

Online evaluation is tree-free on the device: all region hyperplanes are
stacked into one (R * mrow, nth) matrix, so locating a batch of
parameters is one matrix product, a max over each region's rows and an
argmin over regions (``evaluate_batch``, float64 by default). A binary
search tree (``build_tree``) is also available for host evaluation parity
with the reference API.

The device is the caller's: ``build_explicit(device=None)`` takes the
device of ``mpc.engine`` once it is set up, else the card; the
controller keeps it. Deliberate difference from the JAX package: the BST
build sends its support LPs unpadded (the JAX package pads the lane count
to a power of two to reuse XLA compiles; the lanes are independent, so
the real lanes' results do not change).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .condense import mpc2mpqp
from .ops.engine import resolve_device
from .ops.ldp import qp2ldp
from .ops.lp_ipm import chebyshev_batch, support_batch
from .ops.reference_solver import solve_ldp_numpy
from .types import ACTIVE, IMMUTABLE, MPQP, SOFT


# ---------------------------------------------------------------------------
# Single-sided transform (reference src/utils.jl:329-391)
# ---------------------------------------------------------------------------

@dataclass
class SingleSidedQP:
    H: np.ndarray
    f: np.ndarray
    f_theta: np.ndarray
    H_theta: np.ndarray
    A: np.ndarray        # (2m[-pruned], n[+nsoft])
    b: np.ndarray
    W: np.ndarray
    senses: np.ndarray
    bounds_table: np.ndarray
    prio: np.ndarray
    has_binaries: bool
    n_decision: int      # original decision dims (before slack columns)


def make_singlesided(mpqp: MPQP, *, single_soft: bool = False, soft_weight: float = 1e6) -> SingleSidedQP:
    """bl + W th <= A U <= bu + W th  ->  A U <= b + W th, with soft
    constraints made explicit through Cholesky-normalized slack columns."""
    ncstr = len(mpqp.bu)
    n_bounds = ncstr - mpqp.A.shape[0]
    bounds_table = np.concatenate([np.arange(ncstr, 2 * ncstr), np.arange(ncstr)])
    n = mpqp.H.shape[0]
    A0 = np.vstack([np.hstack([np.eye(n_bounds), np.zeros((n_bounds, n - n_bounds))]), mpqp.A])
    A = np.vstack([A0, -A0])

    senses = np.tile(mpqp.senses, 2)
    prio = np.tile(mpqp.prio, 2)

    H, f, f_theta = mpqp.H, mpqp.f.copy(), mpqp.f_theta.copy()

    soft_mask = (mpqp.senses & SOFT) == SOFT
    if np.any(soft_mask):
        soft_ids = np.where(soft_mask)[0]
        R = np.linalg.cholesky((mpqp.H + mpqp.H.T) / 2).T  # upper factor
        Ms = np.linalg.solve(R.T, A0[soft_mask, :].T).T    # A0[soft] / R
        norm_factors = np.linalg.norm(Ms, axis=1)

        if single_soft:
            nsoft = 1
            A = np.hstack([A, np.zeros((A.shape[0], 1))])
            A[soft_ids, -1] = -norm_factors
            A[soft_ids + ncstr, -1] = -norm_factors
        else:
            nsoft = len(soft_ids)
            A = np.hstack([A, np.zeros((2 * ncstr, nsoft))])
            A[soft_ids, n + 0:] = -np.diag(norm_factors)
            A[soft_ids + ncstr, n + 0:] = -np.diag(norm_factors)
        H = np.block([
            [H, np.zeros((n, nsoft))],
            [np.zeros((nsoft, n)), soft_weight * np.eye(nsoft)],
        ])
        f = np.concatenate([f, np.zeros(nsoft)])
        f_theta = np.vstack([f_theta, np.zeros((nsoft, f_theta.shape[1]))])

    b = np.concatenate([mpqp.bu, -mpqp.bl])
    W = np.vstack([mpqp.W, -mpqp.W])

    # prune infinite bounds, fixing up the bounds table
    rm_ids = np.where(b >= 1e20)[0]
    if len(rm_ids):
        bounds_table[bounds_table[rm_ids]] = bounds_table[rm_ids]
        keep_ids, offset_map = [], np.zeros(2 * ncstr, dtype=int)
        rm_set = set(rm_ids.tolist())
        new_id = 0
        for i in range(2 * ncstr):
            if i in rm_set:
                offset_map[i] = -1
            else:
                offset_map[i] = new_id
                keep_ids.append(i)
                new_id += 1
        keep_ids = np.asarray(keep_ids)
        A, b, W = A[keep_ids], b[keep_ids], W[keep_ids]
        senses, prio = senses[keep_ids], prio[keep_ids]
        bt = bounds_table[keep_ids]
        bounds_table = np.array([offset_map[j] if offset_map[j] >= 0 else k
                                 for k, j in enumerate(bt)], dtype=int)

    return SingleSidedQP(
        H=H, f=f, f_theta=f_theta, H_theta=mpqp.H_theta,
        A=A, b=b, W=W, senses=senses, bounds_table=bounds_table, prio=prio,
        has_binaries=mpqp.has_binaries, n_decision=n,
    )


# ---------------------------------------------------------------------------
# LP helpers (host)
# ---------------------------------------------------------------------------

def _chebyshev_radius(A, b, lb, ub):
    """Largest ball inside {A th <= b, lb <= th <= ub}. Returns (radius,
    center) or (-inf, None) if empty."""
    from scipy.optimize import linprog

    nth = A.shape[1] if A.size else len(lb)
    norms = np.linalg.norm(A, axis=1) if A.size else np.zeros((0,))
    # variables [th; r], maximize r
    A_ub = np.hstack([A, norms[:, None]]) if A.size else np.zeros((0, nth + 1))
    box_rows = []
    box_rhs = []
    for i in range(nth):
        e = np.zeros(nth + 1)
        e[i], e[-1] = 1.0, 1.0
        box_rows.append(e.copy())
        box_rhs.append(ub[i])
        e[i] = -1.0
        box_rows.append(e.copy())
        box_rhs.append(-lb[i])
    A_ub = np.vstack([A_ub, np.asarray(box_rows)]) if box_rows else A_ub
    b_ub = np.concatenate([b, np.asarray(box_rhs)]) if box_rows else b
    c = np.zeros(nth + 1)
    c[-1] = -1.0
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=[(None, None)] * nth + [(0, None)],
                  method="highs")
    if not res.success:
        return -np.inf, None
    return res.x[-1], res.x[:nth]


# bytes of the (chunk, R, mrow) violation block of one evaluate_batch chunk
EVAL_BLOCK_BYTES = 1 << 28


@dataclass
class CriticalRegion:
    active_set: tuple
    Ath: np.ndarray     # region: Ath @ theta <= bth
    bth: np.ndarray
    F: np.ndarray       # decision feedback U(theta) = F theta + g (full U)
    g: np.ndarray
    Flam: np.ndarray    # lambda(theta) = Flam theta + glam over active set
    glam: np.ndarray
    center: np.ndarray = None


@dataclass
class ExplicitMPC:
    """Explicit controller (reference src/explicit.jl:1-48)."""

    regions: list
    qp: SingleSidedQP
    nth: int
    nu: int
    lb: np.ndarray
    ub: np.ndarray
    mpc: object = None
    bst: object = None
    # where the LP oracle and the batched evaluation run (None: the card)
    device: torch.device | None = None
    # counts of the enumeration: IPM chunks and lanes, HiGHS confirmations
    stats: dict | None = None
    # stacked arrays for batched evaluation
    _eval_arrays: object = None

    # -- reference-compatible runtime ------------------------------------
    def __getattr__(self, name):
        # delegate spec/observer attributes to the source controller so the
        # explicit controller is a drop-in for simulation (reference keeps
        # parallel fields on its ExplicitMPC struct, src/explicit.jl:1-21)
        mpc = object.__getattribute__(self, "mpc")
        if mpc is None:
            raise AttributeError(name)
        return getattr(mpc, name)

    def form_parameter(self, x, r=None, d=None, uprev=None, p=None):
        return self.mpc.form_parameter(x, r, d, uprev, p)

    def compute_control(self, x, *, r=None, d=None, uprev=None, p=None, check=True):
        theta = self.form_parameter(x, r, d, uprev, p)
        u = self.evaluate(theta)
        if check and u is None:
            raise RuntimeError("parameter outside the explicit solution's region")
        self.mpc.uprev = u.copy()
        return u

    def evaluate(self, theta) -> np.ndarray | None:
        """Host point location: first region containing theta. The stored
        gains already include the prestabilizing-feedback correction."""
        theta = np.asarray(theta, dtype=np.float64).ravel()
        best, best_viol = None, np.inf
        for cr in self.regions:
            viol = float(np.max(cr.Ath @ theta - cr.bth, initial=-np.inf))
            if viol <= 1e-8:
                return cr.F[: self.nu] @ theta + cr.g[: self.nu]
            if viol < best_viol:
                best, best_viol = cr, viol
        if best is not None and best_viol < 1e-5:  # boundary jitter
            return best.F[: self.nu] @ theta + best.g[: self.nu]
        return None

    # -- binary search tree (host point location; reference build_tree!,
    #    src/explicit.jl:65-71 -- the batched device path uses evaluate_batch)
    def build_tree(self, *, leaf_size: int = 16, max_depth: int = 24,
                   max_cand: int = 64, lp_tol: float = 1e-9):
        """Exact point-location BST over the region partition.

        Region-vs-hyperplane sides are classified EXACTLY (ParametricDAQP's
        generated-C role, reference src/codegen.jl:62-137): a region goes
        only to the low (high) branch when it provably lies in the closed
        halfspace, else to both. Proof ladder, cheapest first, all memoized:
          1. the region's inscribed ball straddles the plane -> 'both';
          2. the region's bounding box (2 nth LPs once per region) lies in
             one halfspace -> one-sided;
          3. an exact support LP  max/min a'theta  over the region.
        Every leaf therefore contains every region intersecting its cell:
        descent + leaf scan is exact up to LP tolerance, and the C emission
        (codegen_c_explicit) evaluates in O(depth + leaf_size) per step.
        """
        nth = self.nth
        regions = self.regions
        Rn = len(regions)

        # unique hyperplane pool (normalized rows; canonical sign)
        pool, seen = [], {}
        region_faces = []
        for cr in regions:
            faces = []
            for row, rhs in zip(cr.Ath, cr.bth):
                nrm = float(np.linalg.norm(row))
                if nrm <= 1e-12:
                    continue
                a, b = row / nrm, float(rhs) / nrm
                # sign-defining coordinate: the largest-magnitude entry
                # (argmax of a thresholded mask returns index 0 when every
                # entry is tiny, making the sign key arbitrary)
                s = 1.0 if (a[np.argmax(np.abs(a))] >= 0) else -1.0
                key = tuple(np.round(np.append(a * s, b * s), 9))
                hid = seen.get(key)
                if hid is None:
                    hid = len(pool)
                    seen[key] = hid
                    pool.append((a * s, b * s))
                faces.append(hid)
            region_faces.append(faces)

        # per-region certified data, computed through the BATCHED IPM LP
        # oracle (ops/lp_ipm.py) -- thousands of scipy calls would dominate
        # the build otherwise. Classification stays SOUND because only
        # one-sided verdicts need certification (duality-gap-certified
        # bounds); any LP uncertainty degrades to 'both', which only makes
        # leaves fatter, never wrong.
        dev = resolve_device(self.device)
        mrow = max([len(cr.bth) for cr in regions] + [1])
        As_all = np.zeros((Rn, mrow, nth))
        bs_all = np.ones((Rn, mrow))
        for i, cr in enumerate(regions):
            if len(cr.bth):
                As_all[i, : len(cr.bth)] = cr.Ath
                bs_all[i, : len(cr.bth)] = cr.bth
        ball_r, cents, _gaps = chebyshev_batch(As_all, bs_all, self.lb, self.ub, device=dev)
        ball_r = np.maximum(ball_r, 0.0)
        for i, cr in enumerate(regions):
            if cr.center is None and ball_r[i] > 0:
                cr.center = cents[i]
        # a usable interior start must be strictly inside region and box
        slack_min = np.min(bs_all - np.einsum("rmn,rn->rm", As_all, cents), axis=1)
        interior = (ball_r > 1e-9) & (slack_min > 1e-11) \
            & np.all(cents > self.lb + 1e-11, axis=1) \
            & np.all(cents < self.ub - 1e-11, axis=1)
        # certified OUTER bounding boxes: 2*nth batched support LPs
        box_lo = np.tile(self.lb, (Rn, 1))
        box_hi = np.tile(self.ub, (Rn, 1))
        for i in range(nth):
            e = np.zeros((Rn, nth))
            e[:, i] = 1.0
            val, slack, _g = support_batch(As_all, bs_all, self.lb, self.ub, e, cents,
                                          device=dev)
            lo_cert = np.maximum(val - slack, self.lb[i])
            val, slack, _g = support_batch(As_all, bs_all, self.lb, self.ub, -e, cents,
                                          device=dev)
            hi_cert = np.minimum(-val + slack, self.ub[i])
            box_lo[:, i] = np.where(interior, lo_cert, self.lb[i])
            box_hi[:, i] = np.where(interior, hi_cert, self.ub[i])
        # certification slack: duality gap + headroom for the IPM's
        # geometry-limited accuracy on near-parallel rows (ops/lp_ipm.py);
        # looseness only classifies more pairs 'both' (fatter leaves)
        cert_tol = max(lp_tol, 1e-6)

        side_memo: dict = {}

        def classify_pairs(pairs):
            """Resolve (rid, hid) pairs into side_memo: -1 low / +1 high /
            0 straddles. Cheap ladder first; survivors share one batched
            support-LP call."""
            need = []
            for rid, hid in pairs:
                if (rid, hid) in side_memo:
                    continue
                a, b = pool[hid]
                mgn = float(a @ cents[rid] - b)
                if ball_r[rid] > 0 and abs(mgn) < ball_r[rid] - lp_tol:
                    side_memo[(rid, hid)] = 0  # inscribed ball straddles
                    continue
                ctr = (box_lo[rid] + box_hi[rid]) / 2
                half = (box_hi[rid] - box_lo[rid]) / 2
                mid = float(a @ ctr - b)
                ext = float(np.abs(a) @ half)
                if mid + ext <= cert_tol:
                    side_memo[(rid, hid)] = -1
                    continue
                if mid - ext >= -cert_tol:
                    side_memo[(rid, hid)] = 1
                    continue
                if not interior[rid]:
                    side_memo[(rid, hid)] = 0  # degenerate region: be safe
                    continue
                need.append((rid, hid, mgn < 0))
            if not need:
                return
            rids = np.asarray([p[0] for p in need])
            cs = np.stack([
                -pool[hid][0] if try_lo else pool[hid][0]
                for _rid, hid, try_lo in need])
            val, slack, _g = support_batch(
                As_all[rids], bs_all[rids], self.lb, self.ub, cs, cents[rids], device=dev)
            for k, (rid, hid, try_lo) in enumerate(need):
                b = pool[hid][1]
                if try_lo:
                    # certified upper bound of max a'theta over the region
                    side_memo[(rid, hid)] = -1 if (-val[k] + slack[k] - b
                                                   <= cert_tol) else 0
                else:
                    side_memo[(rid, hid)] = 1 if (val[k] - slack[k] - b
                                                  >= -cert_tol) else 0

        def classify(rid, hid):
            if (rid, hid) not in side_memo:
                classify_pairs([(rid, hid)])
            return side_memo[(rid, hid)]

        def build(region_ids, depth):
            if len(region_ids) <= leaf_size or depth >= max_depth:
                return ("leaf", region_ids)
            # candidates: faces of the node's own regions, most shared first
            counts: dict = {}
            for rid in region_ids:
                for hid in region_faces[rid]:
                    counts[hid] = counts.get(hid, 0) + 1
            cands = sorted(counts, key=counts.get, reverse=True)[:max_cand]
            # two-phase selection keeps the LP count tractable: score every
            # candidate by the FREE center-side balance, then classify only
            # the most-balanced few exactly (one batched LP call per node)
            centers = cents[np.asarray(region_ids)]
            scored = []
            for hid in cands:
                a, b = pool[hid]
                mgn = centers @ a - b
                n_lo, n_hi = int((mgn <= 0).sum()), int((mgn > 0).sum())
                scored.append((max(n_lo, n_hi), hid))
            scored.sort()
            classify_pairs([(rid, hid) for _s, hid in scored[:8]
                            for rid in region_ids])
            nS = len(region_ids)
            # a split must make real progress: straddling regions are
            # DUPLICATED into both branches, and accepting barely-shrinking
            # splits explodes the tree (observed 97k-255k nodes for ~650
            # regions with weaker guards); demand the larger branch strip
            # >= 25% of the node, else leaf out -- the C evaluator's leaf
            # scan is cheap, exploding trees are not
            min_progress = nS - max(2, nS // 4)

            def exact_split(hid):
                lo, hi_ = [], []
                for rid in region_ids:
                    s = classify(rid, hid)
                    if s <= 0:
                        lo.append(rid)
                    if s >= 0:
                        hi_.append(rid)
                worst = max(len(lo), len(hi_))
                if worst > min_progress:
                    return None
                dup = len(lo) + len(hi_) - nS
                return (worst + 0.5 * dup, hid, lo, hi_)

            best = None
            for _h_score, hid in scored[:8]:
                cand = exact_split(hid)
                if cand and (best is None or cand[0] < best[0]):
                    best = cand
            if best is None:
                # the balanced-looking planes all failed: wider exact sweep
                # in batches of 8 candidates (pair-at-a-time classification
                # would pay one IPM dispatch per pair) before giving up
                rest = [hid for _s, hid in scored[8:]]
                for i0 in range(0, len(rest), 8):
                    grp = rest[i0 : i0 + 8]
                    classify_pairs([(rid, hid) for hid in grp
                                    for rid in region_ids])
                    for hid in grp:
                        best = exact_split(hid)
                        if best is not None:
                            break
                    if best is not None:
                        break
            if best is None:
                return ("leaf", region_ids)
            _, hid, lo, hi_ = best
            a, b = pool[hid]
            return ("node", a, b, build(lo, depth + 1), build(hi_, depth + 1))

        self.bst = build(list(range(Rn)), 0)
        return self.bst

    def bst_arrays(self):
        """Flatten the BST into arrays for C emission / inspection:
        (A (n_nodes, nth), b (n_nodes,), kids (n_nodes, 2) with negative
        ``-(leaf_id+1)``, leaf_offsets, leaf_regions, depth)."""
        if self.bst is None:
            self.build_tree()
        As, bs, kids = [], [], []
        leaf_off, leaf_reg = [0], []

        def walk(node):
            if node[0] == "leaf":
                leaf_reg.extend(node[1])
                leaf_off.append(len(leaf_reg))
                return -(len(leaf_off) - 1)  # -(leaf_id + 1)
            _, a, b, lo, hi_ = node
            my = len(As)
            As.append(a)
            bs.append(b)
            kids.append([0, 0])
            kids[my][0] = walk(lo)
            kids[my][1] = walk(hi_)
            return my

        root = walk(self.bst)
        if not As:  # single-leaf tree
            As.append(np.zeros(self.nth))
            bs.append(np.inf)
            kids.append([-1, -1])
        depth = 0

        def _d(node):
            return 1 + max(_d(node[3]), _d(node[4])) if node[0] == "node" else 0

        depth = _d(self.bst)
        return (np.asarray(As), np.asarray(bs), np.asarray(kids, dtype=int),
                np.asarray(leaf_off, dtype=int), np.asarray(leaf_reg, dtype=int),
                depth, root)

    def evaluate_tree(self, theta):
        """BST descent + candidate check (falls back to full scan on miss)."""
        if self.bst is None:
            self.build_tree()
        theta = np.asarray(theta, dtype=np.float64).ravel()
        node = self.bst
        while node[0] == "node":
            _, a, b, lo, hi_ = node
            node = hi_ if a @ theta - b > 0 else lo
        for rid in node[1]:
            cr = self.regions[rid]
            if np.max(cr.Ath @ theta - cr.bth, initial=-np.inf) <= 1e-8:
                return cr.F[: self.nu] @ theta + cr.g[: self.nu]
        return self.evaluate(theta)

    def build_eval_arrays(self, dtype=torch.float64):
        """Stack all region hyperplanes and feedbacks on the controller's
        device for batched evaluation: A (R * mrow, nth), b (R, mrow) with
        padding rows at 1e30, F (R, nu, nth), g (R, nu)."""
        R = len(self.regions)
        max_rows = max(len(cr.bth) for cr in self.regions)
        A = np.zeros((R, max_rows, self.nth))
        b = np.full((R, max_rows), 1e30)
        F = np.zeros((R, self.nu, self.nth))
        g = np.zeros((R, self.nu))
        for i, cr in enumerate(self.regions):
            A[i, : len(cr.bth)] = cr.Ath
            b[i, : len(cr.bth)] = cr.bth
            F[i] = cr.F[: self.nu]
            g[i] = cr.g[: self.nu]
        dev = resolve_device(self.device)
        self._eval_arrays = tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                                  for a in (A.reshape(R * max_rows, self.nth), b, F, g))
        return self._eval_arrays

    def evaluate_batch(self, thetas):
        """Batched point location + affine feedback on the device: the
        region of least violation (max over its rows of A th - b), its
        u = F th + g. ``thetas`` (B, nth), NumPy or a tensor; returns
        (u (B, nu), viol (B,)) tensors on the controller's device, in the
        dtype of ``build_eval_arrays`` (float64 unless asked). B is cut
        into chunks that keep the (chunk, R, mrow) violation block under
        ``EVAL_BLOCK_BYTES``."""
        if self._eval_arrays is None:
            self.build_eval_arrays()
        A, b, F, g = self._eval_arrays
        th = torch.as_tensor(thetas).to(device=A.device, dtype=A.dtype)
        R, mrow = b.shape
        Bc = max(1, EVAL_BLOCK_BYTES // (R * mrow * A.element_size()))
        us, viols = [], []
        for t in th.split(Bc):
            # violation of each region: max over its rows
            viol = ((A @ t.T).view(R, mrow, -1) - b[:, :, None]).amax(1)  # (R, Bc)
            best, idx = viol.min(0)
            us.append(torch.bmm(F[idx], t[:, :, None])[:, :, 0] + g[idx])
            viols.append(best)
        return torch.cat(us), torch.cat(viols)


def build_explicit(mpc, *, prange=None, max_regions: int = 10000,
                   single_soft: bool = True, build_tree: bool = False,
                   region_tol: float = 1e-9, oracle: str = "batch",
                   device=None) -> ExplicitMPC:
    """Enumerate the critical regions of the mpQP over ``prange``.

    BFS over active-set neighbors: each irredundant facet of a region is
    either a lambda_i >= 0 boundary (drop i) or an inactive-constraint
    boundary (add j); candidate regions are kept when their Chebyshev
    radius over the parameter box is positive.

    ``build_tree`` is accepted for the JAX package's signature and unused,
    as there. ``oracle``: "batch" solves each frontier wave's Chebyshev LPs in one
    batched interior-point call on ``device`` (ops/lp_ipm.py), confirming
    borderline lanes on the host; "host" solves one HiGHS LP per candidate
    (the reference-style serial path). ``device`` (``offline_device``):
    the caller's, else the device of ``mpc.engine``, else the card. The
    controller's ``stats`` counts the IPM chunks and lanes and the HiGHS
    LPs (``highs``: the host oracle's, or the batch oracle's
    confirmations).
    """
    import warnings

    dev = offline_device(mpc, device)
    stats = dict(ipm_chunks=0, ipm_lanes=0, highs=0)
    qp = make_singlesided(mpc2mpqp(mpc), single_soft=single_soft,
                          soft_weight=mpc.settings.soft_weight)
    if qp.has_binaries:
        warnings.warn("Explicit controllers currently not supported for hybrid systems")
        return None
    if prange is None:
        warnings.warn("No parameter range defined. Using default limits [-100, 100].")
        prange = mpc.parameter_range()
    lb, ub = prange.lower(), prange.upper()
    nth = qp.W.shape[1]
    n = qp.H.shape[0]
    m = qp.A.shape[0]

    # non-symmetric H (game-theoretic AVI mode): the KKT conditions
    # H U + f_t + A' lam = 0, lam >= 0 stay affine in theta, so the same
    # enumeration applies with the unsymmetrized inverse
    sym = np.allclose(qp.H, qp.H.T, rtol=1e-9)
    Hinv = np.linalg.inv((qp.H + qp.H.T) / 2 if sym else qp.H)
    AHinv = qp.A @ Hinv          # (m, n)
    AHA = AHinv @ qp.A.T         # (m, m)
    # unconstrained solution U0(th) = -Hinv (f + f_theta th)
    U0F = -Hinv @ qp.f_theta
    U0g = -Hinv @ qp.f

    ignore = (qp.senses & IMMUTABLE) != 0
    always = ((qp.senses & ACTIVE) != 0)

    def rows_of(active_set):
        """Assemble the candidate region's hyperplanes (no feasibility
        check), or None if the working-set system is singular."""
        AS = np.asarray(sorted(active_set), dtype=int)
        if len(AS) > n:
            return None
        if len(AS):
            M = AHA[np.ix_(AS, AS)]
            try:
                Minv = np.linalg.inv(M)
            except np.linalg.LinAlgError:
                return None
            if np.linalg.cond(M) > 1e12:
                return None
            # lambda(th) = Minv (A_AS U0(th) - b_AS - W_AS th) >= 0
            Flam = Minv @ (qp.A[AS] @ U0F - qp.W[AS])
            glam = Minv @ (qp.A[AS] @ U0g - qp.b[AS])
            F = U0F - Hinv @ qp.A[AS].T @ Flam
            g = U0g - Hinv @ qp.A[AS].T @ glam
        else:
            Flam = np.zeros((0, nth))
            glam = np.zeros(0)
            F, g = U0F, U0g

        rows, rhs = [], []
        # dual feasibility: lambda_i >= 0  ->  -Flam th <= glam
        for k, i in enumerate(AS):
            if always[i]:
                continue
            rows.append(-Flam[k])
            rhs.append(glam[k])
        # primal feasibility of inactive rows: A_j U(th) <= b_j + W_j th
        inact = np.setdiff1d(np.arange(m), AS)
        inact = inact[~ignore[inact]]
        if len(inact):
            Arows = qp.A[inact] @ F - qp.W[inact]
            brows = qp.b[inact] - qp.A[inact] @ g
            rows.extend(Arows)
            rhs.extend(brows)
        Ath = np.asarray(rows) if rows else np.zeros((0, nth))
        bth = np.asarray(rhs) if rhs else np.zeros(0)
        # normalize rows
        if len(bth):
            nrm = np.linalg.norm(Ath, axis=1)
            ok = nrm > 1e-12
            Ath[ok] = Ath[ok] / nrm[ok, None]
            bth[ok] = bth[ok] / nrm[ok]
        return tuple(AS.tolist()), Ath, bth, F, g, Flam, glam

    def region_of(active_set):
        """Critical region via the host (HiGHS) Chebyshev LP, or None."""
        built = rows_of(active_set)
        if built is None:
            return None
        AS, Ath, bth, F, g, Flam, glam = built
        stats["highs"] += 1
        r, center = _chebyshev_radius(Ath, bth, lb, ub)
        if r <= region_tol or center is None:
            return None
        return CriticalRegion(AS, Ath, bth, F, g, Flam, glam, center)

    def regions_of_batch(active_sets):
        """Batched feasibility oracle (ops/lp_ipm.py): solve the whole
        frontier's Chebyshev LPs in one device call; borderline lanes
        (|r - region_tol| < 1e-4) are confirmed by the host LP."""
        built = [rows_of(AS) for AS in active_sets]
        live = []
        out = []
        for bi in built:
            if bi is None:
                continue
            AS, Ath, bth, F, g, Flam, glam = bi
            # numerically-zero rows: "0 <= b" -- infeasible artifact of a
            # degenerate working set when b < 0, vacuous otherwise (these
            # rows destabilize the IPM; HiGHS handles them implicitly)
            if len(bth):
                nrm = np.linalg.norm(Ath, axis=1)
                zero = nrm <= 1e-12
                if np.any(bth[zero] < -1e-9):
                    continue
                if np.any(zero):
                    bi = (AS, Ath[~zero], bth[~zero], F, g, Flam, glam)
            if len(bi[2]) == 0:  # unconstrained region
                out.append(CriticalRegion(AS, bi[1], bi[2], F, g, Flam, glam,
                                          (lb + ub) / 2))
            else:
                live.append(bi)
        if not live:
            return out
        m_pad = max(len(bi[2]) for bi in live)
        m_pad = ((m_pad + 31) // 32) * 32
        B = len(live)
        As = np.zeros((B, m_pad, nth))
        bs = np.ones((B, m_pad))
        for k, bi in enumerate(live):
            Ath, bth = bi[1], bi[2]
            As[k, : len(bth)] = Ath
            bs[k, : len(bth)] = bth
        rs, centers, gaps = chebyshev_batch(As, bs, lb, ub, device=dev, stats=stats)
        for k, bi in enumerate(live):
            r, center = rs[k], centers[k]
            # borderline, stalled (large complementarity gap), or
            # non-converged lanes: confirm on the host LP
            # 1e-4 window: on near-parallel-row geometries the IPM radius
            # can be off by a few 1e-6 at tiny duality gap (QR-IPM note
            # in ops/lp_ipm.py); only the host LP certifies the sign there
            if (not np.isfinite(r) or abs(r - region_tol) < 1e-4
                    or gaps[k] > 1e-9):
                stats["highs"] += 1
                r, center = _chebyshev_radius(bi[1], bi[2], lb, ub)
                if center is None:
                    continue
            if r <= region_tol:
                continue
            AS, Ath, bth, F, g, Flam, glam = bi
            out.append(CriticalRegion(AS, Ath, bth, F, g, Flam, glam,
                                      np.asarray(center)))
        return out

    # seed: optimal active set at the box center (and corners fallback)
    ldp = qp2ldp(mpc.mpQP, soft_weight=mpc.settings.soft_weight)
    seeds = [np.clip((lb + ub) / 2, lb, ub)]
    rng = np.random.default_rng(0)
    seeds += [lb + (ub - lb) * rng.random(nth) for _ in range(8)]

    def as_from_point(theta):
        U, lam, work, it, status = solve_ldp_numpy(ldp, theta)
        if status != 1:
            return None
        # map double-sided active rows to single-sided row ids
        mp_total = len(mpc.mpQP.bu)
        AS = []
        for i in work:
            upper = lam[i] >= 0
            ss_row = i if upper else i + mp_total
            # account for pruned infinite rows: find matching row by content
            AS.append(ss_row)
        return _remap_pruned(AS, mp_total, qp)

    def _remap_pruned(AS, mp_total, qp):
        # rows of the single-sided qp correspond to kept ids of [upper; lower]
        if qp.A.shape[0] == 2 * mp_total:
            return tuple(sorted(AS))
        # rebuild keep map
        b_full = np.concatenate([mpc.mpQP.bu, -mpc.mpQP.bl])
        keep = np.where(b_full < 1e20)[0]
        pos = {int(j): k for k, j in enumerate(keep)}
        out = [pos[j] for j in AS if j in pos]
        return tuple(sorted(out))

    queue: list[tuple] = []
    seen: set[tuple] = set()
    for s in seeds:
        AS = as_from_point(s)
        if AS is not None and AS not in seen:
            seen.add(AS)
            queue.append(AS)
    if not queue:
        queue = [tuple(np.where(always)[0].tolist())]
        seen = set(queue)

    regions = []
    while queue and len(regions) < max_regions:
        # frontier wave: one batched device LP call for the whole frontier
        # ("host" oracle: one HiGHS LP per candidate)
        if oracle == "batch":
            wave, queue = queue, []
            accepted = regions_of_batch(wave)
        else:
            wave = [queue.pop()]
            cr = region_of(wave[0])
            accepted = [cr] if cr is not None else []
        for cr in accepted:
            if len(regions) >= max_regions:
                break
            regions.append(cr)
            AS = cr.active_set
            # neighbors: drop each non-forced active row, add each inactive
            for i in AS:
                if not always[i]:
                    cand = tuple(sorted(set(AS) - {i}))
                    if cand not in seen:
                        seen.add(cand)
                        queue.append(cand)
            inact = [j for j in range(m) if j not in AS and not ignore[j]]
            for j in inact:
                if qp.bounds_table[j] in AS:
                    continue  # both sides of one hyperplane cannot be active
                cand = tuple(sorted(set(AS) | {j}))
                if len(cand) <= n and cand not in seen:
                    seen.add(cand)
                    queue.append(cand)

    # prestabilizing-feedback correction of stored gains
    # (reference src/explicit.jl:65-71: feedbacks[1:nx,:] -= K')
    K = mpc.K
    nx = mpc.model.nx
    for cr in regions:
        cr.F[: mpc.model.nu, :nx] -= K

    return ExplicitMPC(
        regions=regions, qp=qp, nth=nth, nu=mpc.model.nu,
        lb=lb, ub=ub, mpc=mpc, device=dev, stats=stats,
    )


def offline_device(mpc, device) -> torch.device:
    """The device of an offline analysis: ``device`` where the caller names
    one, else the device of ``mpc.engine``, else the card (``resolve_device``:
    without CUDA it raises). A problem a mutator invalidated is set up
    again first, on ``device`` where one is named."""
    if not mpc.mpqp_issetup:
        if device is not None:
            mpc.setup(device=device)
        else:
            mpc.ensure_setup()
    return resolve_device(device if device is not None else mpc.engine.device)
