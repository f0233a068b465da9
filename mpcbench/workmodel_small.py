"""The work a closed-loop cell asks of the small-m tier's two kernels, K1
(the float32 bulk phase) and K2 (the float64 polish), counted from the
cell's shapes and the plain reference's working sets, never from the
program's counters, as ``workmodel.py`` counts K3's.

A warm step of a lane, whose reference working set holds w rows of the
m bound rows after ``added`` of them entered since the previous step:

* K1, operations: one iteration for each added row and one that certifies
  the final set, at the sizes the set grows through (w - added, ..., w).
  An iteration is the working-set solve with the subset table's inverse
  (2 s^2 at s rows), the slacks G lam of the m rows (2 m s) and each
  row's test against its two bounds (4 m). Rows that leave the set are
  not counted.
* K2, operations: the float64 bounds d = d0 + Dth theta (2 m n_theta), the
  working-set solve (2 w^2) and the recovery U = u_off + Uth theta -
  HinvET lam (2 n n_theta + 2 n w). The objective and the KKT residual
  are not counted.
* bytes: a lane's inputs read and outputs written once, and the subset
  table and the static matrices once a launch.

So a change that saves iterations or stops moving a tensor leaves the
yardstick where it was. Peaks: the H100 SXM's float32 rate outside the
tensor cores, 67 TFLOP/s (K1), its float64 rate outside them, 34 TFLOP/s
(K2), and its HBM3 bandwidth, 3.35 TB/s (NVIDIA's data sheet).
"""

from __future__ import annotations

PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_F64 = 34e12
PEAK_BYTES_PER_S = 3.35e12


def k1_iteration_flops(m: int, s: int) -> float:
    """One bulk-phase iteration at a working set of s rows."""
    return 2.0 * s * s + 2.0 * m * s + 4.0 * m


def k1_step_flops(m: int, w: int, added: int) -> float:
    """A warm step that ends at w rows after ``added`` entered."""
    return sum(k1_iteration_flops(m, s) for s in range(int(w) - int(added), int(w) + 1))


def k1_lane_bytes(m: int) -> float:
    """The float32 bounds du and dl in, the multipliers in and out (4 m
    values), the working set and its sides in and out (4 m bytes), the
    iteration count (int32) and the convergence flag out."""
    return 4.0 * 4 * m + 4.0 * m + 5.0


def k1_launch_bytes(m: int) -> float:
    """The float32 subset table (2^m inverses of m x m) and G (m x m)."""
    return 4.0 * (2 ** m * m * m + m * m)


def k2_step_flops(m: int, n: int, n_theta: int, w: int) -> float:
    """The bounds, the working-set solve and the recovery of U."""
    return 2.0 * m * n_theta + 2.0 * w * w + 2.0 * n * n_theta + 2.0 * n * w


def k2_lane_bytes(m: int, n: int, n_theta: int) -> float:
    """theta in (float64), the working set and its sides in (2 m bytes);
    U, the multipliers, the objective and the residual out (float64)."""
    return 8.0 * n_theta + 2.0 * m + 8.0 * (n + m + 2)


def k2_launch_bytes(m: int, n: int, n_theta: int) -> float:
    """The float64 subset table and statics: Dth (m x n_theta), du, dl, G,
    HinvET (n x m), Uth (n x n_theta), u_off, H (n x n), f, f_theta (n x
    n_theta)."""
    statics = m * n_theta + 2 * m + m * m + n * m + 2 * n * n_theta + 2 * n + n * n
    return 8.0 * (2 ** m * m * m + statics)


def roofline_pct(flops: float, peak_flops: float, nbytes: float, kernel_s: float) -> float | None:
    """Least time for the work over the kernel's device time, in %; None
    when there is no kernel time or no work to read."""
    if kernel_s <= 0 or flops <= 0:
        return None
    return 100.0 * max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S) / kernel_s


def warm_share(step_flops, lane_bytes: float, launch_bytes: float, peak_flops: float,
               history, lanes: int, launches: int, kernel_s: float) -> float | None:
    """A kernel's roofline share over ``launches`` warm steps of ``lanes``
    lanes each: ``step_flops(w, added)`` averaged over the reference's
    (working-set size, rows added) ``history`` stands for every
    lane-step; ``lane_bytes`` a lane and ``launch_bytes`` a launch."""
    history = list(history)
    if not history:
        return None
    per = sum(step_flops(w, a) for w, a in history) / len(history)
    return roofline_pct(launches * lanes * per, peak_flops,
                        launches * (lanes * lane_bytes + launch_bytes), kernel_s)
