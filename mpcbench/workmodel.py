"""The work a cell asks of a kernel, counted from the cell's shapes and the
plain reference, never from the program's counters.

Frozen and reworked from ``linearmpc_tpu_torch/profiling.py``
(``gi_flops_per_lane_iter``, ``search_management_flops``,
``iu_bytes_per_lane``, ``bound``): there the operations came from the
iteration counts the kernel returned and the bytes from the port's own
tensors, so a change that saved iterations or stopped moving a tensor
moved its own yardstick. Here:

* operations: the Goldfarb-Idnani additions that reach the reference's
  optimal working set (a cold lane: every row of it, one at a time; a
  warm rollout step: the rows new since the previous step, and one pass
  that verifies the rest), or, for branch-and-bound, the reference's own
  dual active-set iterations and nodes on the checked lanes, scaled to
  the lanes run;
* bytes: theta and the problem's static matrices read once, and what the
  caller receives (U, the multipliers, the working set, the status)
  written once, from the cell's shapes.

Peak: the H100 SXM's float32 rate outside the tensor cores, 67 TFLOP/s,
and its HBM3 bandwidth, 3.35 TB/s (NVIDIA's data sheet). The kernels
iterate in float32 on the vector units, so that rate is their ceiling;
the card's power limit is printed beside every share. A share is the
least time for the work over the kernel's device time, so it cannot
pass 100% unless the work is counted too high.
"""

from __future__ import annotations

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_PER_S = 3.35e12


def gi_iteration_flops(m: int, w: float) -> float:
    """One GI iteration of a lane at a working set of w rows of m: the
    jump, the direction and the inverse's product (m x w each), the slack
    G lam (m x w) and the rank-2 update (w^2)."""
    return iterations_flops(m, w, w * w)


def iterations_flops(m: int, sum_w: float, sum_w2: float) -> float:
    """GI iterations whose working-set sizes add up to ``sum_w`` (their
    squares to ``sum_w2``)."""
    return 8.0 * m * sum_w + 4.0 * sum_w2


def cold_flops(m: int, w_final: int) -> float:
    """The additions that build a working set of ``w_final`` rows from
    empty: one iteration at each size 1..w_final."""
    return sum(gi_iteration_flops(m, w) for w in range(1, int(w_final) + 1))


def warm_flops(m: int, w_final: int, added: int) -> float:
    """A warm step: ``added`` iterations at the final size, and one pass
    of the slacks over the final working set that certifies it."""
    return added * gi_iteration_flops(m, w_final) + 2.0 * m * w_final + 2.0 * m


def management_flops(m: int, n: int) -> float:
    """One branch-and-bound node's bookkeeping: c = G lam, U = U0 -
    HinvET lam, HU and the objective, the dual bound and the
    fractionality of each row."""
    return 2.0 * m * m + 2.0 * n * m + 2.0 * n * n + 4.0 * n + 9.0 * m


def solve_bytes(m: int, n: int, n_theta: int, lanes: int, statics: int) -> float:
    """A batch's bytes: theta (float64) and the statics read once, and U,
    the multipliers (float64), the working set and its sides (a byte a
    row) and the status (int32) written once."""
    return statics + lanes * (8.0 * n_theta + 8.0 * n + 8.0 * m + 2.0 * m + 4.0)


def statics_bytes(m: int, n: int, n_theta: int) -> float:
    """G (m x m), the bound rows' theta map (m x n_theta), the recovery map
    (n x m), H (n x n) and the bounds, in float32."""
    return 4.0 * (m * m + m * n_theta + n * m + n * n + 2 * m + n)


def roofline_pct(flops: float, nbytes: float, kernel_s: float) -> float | None:
    """Least time for the work over the kernel's device time, in %; None
    when there is no kernel time or no work to read."""
    if kernel_s <= 0 or flops <= 0:
        return None
    least = max(flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES_PER_S)
    return 100.0 * least / kernel_s
